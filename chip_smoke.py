#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`unimoe_audio_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card (H100,
sm_90a) and the CUDA toolkit.  Phases, each of which exits non-zero on
failure:

1. set-up: the card's name and power limit (nvidia-smi); the kernel sources
   unimoe_audio_torch/csrc/{flash_attention_fwd,flash_attention_bwd,
   flash_attention_f32,flash_attention_bwd_f32,grouped_gemm}.cu built with
   nvcc, one process per source, in parallel;
2. each hand-written kernel against its plain PyTorch version on the card,
   at the main paths' shapes plus edge cases: ragged, left-padded, S > T,
   non-causal, Dh 64 and the tile edges (T = S = 129; T 64 with S 300; for
   K2 and K3 also T 200 with S 290, where K3's query range starts in
   mid-tile, T > S and H = KV) for the flash kernels, K2 and K3 launched
   twice and compared bit for bit; empty groups, groups smaller than a
   tile, boundaries inside tiles, a budget below S x E, widths of 100 and odd widths
   (cp.async loads), rows past the last group, one group, E = 1 and 64,
   groups split over K5 chunks, for the grouped GEMMs (K4 in both tile
   configurations, K4t with an f32 and a bf16 dy, outputs filled with NaN
   before each launch, K5 launched twice and compared bit for bit).  The
   f32 kernels of K1 (csrc/flash_attention_f32.cu), K2 and K3
   (csrc/flash_attention_bwd_f32.cu) against their plain versions in f32 at
   the prefill and training shapes, their tile edges (K1 and K2: 128 query
   rows, 32-key tiles; K3: 64 keys, 64-row query tiles), pads, S > T with
   S - T starting mid-tile, T > S with dead rows, non-causal, Dh 64, GQA 8:1
   and H = KV, K1, K2 and K3 launched twice and compared bit for bit.  A
   small model's bf16 prefill, and its bf16 training loss and gradient
   (dense and gmm dispatch; then with the tiny vision tower on an image
   batch, with prefix tuning, whose K1 runs over S = T + 10 keys, and with
   LoRA), are held against their f32 CPU runs;
3. the paths through the user's entry points, each with the launch
   counters zeroed just before it and read just after:
   - text to music: `UniMoEAudio.text_to_music` at the full width and
     depth of the flagship model (36 layers, hidden 2048, bf16, random
     weights from a seed; with its 32-block Qwen2.5-VL vision tower, which
     T2M does not run) with the 16 kHz DAC, on four captions long enough
     that the prompt buckets to 128 tokens (so the prefill takes the flash
     kernel), through `generate_chunked`; then repeated short calls for the
     prefill's spread;
   - voice-clone text to speech: `UniMoEAudio.text_to_speech` on the same
     model, four sentences in the voice of a 3 s two-tone wav at 22,050 Hz
     (read, resampled, encoded by the DAC; its codes fill the prompt's
     placeholder slots, so the prompt buckets to 256 tokens and the prefill
     takes K1 at a new shape); then K1 at that prefill's shape against its
     plain version, and two reference checks, card vs CPU: the DAC encode
     of the prompt (share of equal codes) and a 2-layer flagship-width f32
     voice-clone prefill (codec logits);
   - streaming: `UniMoEAudio.text_to_music_stream` on the same model, 2 s
     in chunks of 25 frames (time to the first chunk's audio), and greedy
     `generate_stream` against one `generate` call (equal frames);
   - video+text to music: `UniMoEAudio.video_text_to_music` on the same
     model, four pre-extracted videos (16 to 144 video tokens each) with
     their captions: the tower once per video, its features at the video
     slots of each CFG pair, 3-D mRoPE positions, the prefill through K1,
     decode from T_text + rope_deltas, 5 s at most; then the tower timed
     per video, K1 at that prefill's shape against its plain version, and
     two reference checks, card vs CPU in f32: the tower at full width cut
     to 8 blocks, and a 2-layer flagship-width VT2M prefill fed by it;
   - the serving apps on the same model: one `generate_mixed` batch of two
     T2M requests, a voice-clone TTS request and a VT2M request, sampled
     with a seed each (every stream within its budget, one prefill); the
     continuous slot server (`continuous_server(deterministic=True)`, 4
     slots, t_text 256, a 400-frame horizon, 32-frame chunks) on six
     greedy requests, two admitted mid-flight and one after a compaction
     (every request back within its budget, one K1 prefill per
     admission), then K1 at the admission shape against its plain version;
     the 2-layer flagship-width f32 witnesses at the serving shapes, each
     prefill through the f32 K1: the mixed batch at T_text 256 against each
     request alone, the server at t_text 256 against standalone decodes, and
     `text_to_music_speculative` at T_text 128 against greedy
     `text_to_music(decode_emit=False)` (shares of equal frames, lengths and
     cycles); the codec-logit drift of the mixed batch's first request at
     its first decode step, alone against in the batch, in bf16 and in f32
     (printed, not gated); `text_to_music_speculative` on the flagship
     against greedy `text_to_music(decode_emit=False)`;
     `serve.measure_ttfa`; and the studio's HTTP server on 127.0.0.1 (one
     POST /api/generate, a GET of its wav);
   - the same model cut to its first 12 layers (a view of the same
     tensors) and the same captions through `generate_chunked(...,
     dispatch_mode="gmm")` (the grouped GEMMs in the prefill and in every
     decode step), then short dense and gmm runs in turns, and one of
     each under torch.profiler (launches, device time and device-to-host
     reads per decode step);
   - the HF export: the model cut to its first 4 layers written as
     model.safetensors + config.json in bf16 by `export_hf_checkpoint`
     (bytes, seconds), reloaded through `UniMoEAudio(dir)`, greedy codes of
     four captions equal to the source's;
   - mesh serving: an NCCL process group of one rank, the 1 x 1 x 1
     (data, expert, model) mesh, the 4-layer view on it
     (`UniMoEAudio.use_mesh`, what `build_server` does on several ranks):
     greedy codes equal to the mesh-less run's; a training forward with
     `dispatch_mode="ep"` under the mesh's split batch against dense;
   - quantized serving: the flagship with `serving_mode="int4"` (int4
     experts, `packed_a8` expert compute, the int8 KV cache) on 32 captions
     through `text_to_music` and `generate_chunked` (the a8 branch counted
     in every layer), profiled, then saved as a serving snapshot, reloaded,
     and its greedy codes compared; the flagship with `serving_mode="int8"`
     (its vision tower int8 too) on the four captions and one short
     `video_text_to_music` call; both in turns; `moe_ffn_gmm` over int8 QTensor
     experts with and without an assignment budget against the CPU; a
     2-layer flagship-width reference check, f32, card vs CPU; and
     `serving_mode="int4-gptq"` at 4 layers (GPTQ's output error against
     round-to-nearest int4's); and every serving_mode x kv_cache_dtype x
     a8_compute setting at the tiny config;
   - training: `Trainer.fit` at the flagship width with 4 layers, bf16,
     B 4 x T 2048, remat on, one warm-up and five timed steps, with dense
     dispatch and then with `dispatch_mode="gmm"` on the same batch; then
     `Trainer(mesh=make_mesh(1, 1, 1), fsdp=True)` for two steps beside a
     mesh-less Trainer (losses, parameters, K1-K3 launched, step seconds);
     and `utils.profiling.timeit_in_jit` against `graph_ms` on one K1
     launch at the training shape;
   - the training core at the flagship width cut to 2 layers, on the same
     batch: resume (2 steps, `Trainer.save`, a new Trainer that resumes, 2
     more, against 4 straight, bf16; the checkpoint's bytes, save and
     restore seconds), gradient accumulation in f32 (two micro-steps of the
     batch against one step, through the f32 K1, K2 and K3), the Gumbel /
     straight-through mixer (bf16, beside the closed-form mixer's step
     time) and `save_pretrained` loaded by the port's `UniMoEAudio` (prefill
     codec logits bit for bit);
   - vision training: `Trainer.fit` at the flagship width cut to 2 layers
     with the 32-block tower, bf16, on a batch made by the port's data path
     (two 448 x 448 images through `expand_image_tokens`,
     `preprocess_supervised` and `video_to_patches`, two text samples
     through `ConversationDataset`, `Collator`, `prefetch`): the tower
     trains inside the step; then one step with the tower frozen by
     `trainable_pattern` and one with `train_vision=False`;
   - PEFT at the flagship width cut to 2 layers, bf16, on the training
     batch: one step each of LoRA, prefix tuning (K1 over T + 10 keys) and
     P-tuning, only the adapters moving; `merge_lora` and a greedy
     `text_to_music` on the merged model; an f32 witness, card vs CPU, of
     greedy decoding with the prefix in the cache and with soft prompts;
     dense→MoE surgery of a dense flagship-width model and one step of the
     result; expert shards split and merged at ep 2, 4 and 8;
   - the offload trainers: at the flagship width cut to 2 layers, f32, B 2
     x T 256, three steps each of `Trainer`, `OffloadTrainer` and
     `StreamTrainer` held against each other (jitter on, the same seeds),
     int8 moments against f32 moments, an int8 run resumed from its
     checkpoint against a straight one, a NaN batch skipped, and the
     stream trainer's `evaluate` card vs CPU; then the 36-layer flagship,
     bf16, B 4 x T 2048, through `OffloadTrainer` (f32 moments in
     page-locked host memory) and `StreamTrainer` (int8 moments, two
     micro-batches a step), one warm-up and two timed steps (one for the
     stream trainer) each, and the stream trainer again at 4 layers: its peak device memory grows with
     depth by no more than the boundary activations;
   - sliding-window layers: a 2-layer flagship-width f32 model with one
     sliding layer (window 64), greedy `generate` card vs CPU, no flash.
   The f32 card-vs-CPU checks (voice clone, VT2M, the quantized reference,
   the sliding-window and PEFT witnesses) run the CPU on the card's
   routing (`router_tape`), hold the router logits to the VT2M limit (the
   a8 path's, after int8 roundings, to its logits' limit) and print the
   tokens each layer's own logits would route otherwise (`route_flips`);
4. timing of each kernel, its plain version and one PyTorch library call
   at its path's shapes, with the least time the card could take (K1 also
   at the training shape, against SDPA with a boolean mask and with
   is_causal=True; K4t with the step's bf16 dy and with an f32 dy; the f32
   K1 at the T2M prefill and training shapes and the f32 K2 and K3 at the
   training shape, against SDPA in f32, each bound by a third of the TF32
   rate (their 3xTF32 products), with the CUDA cores' f32 bound printed
   beside it): CUDA
   events over back-to-back calls, and for the kernels and the library
   calls also the replay of a CUDA graph of the calls, each after a write
   that flushes the L2 (`graph_ms`).  A reading that implies more than
   105 % of the card's peak bf16 FLOP rate or memory rate fails the run.

The serving path runs after the small-shape checks and before any
training-shape work; the training-shape checks follow it.

The last lines of standard output are one JSON object describing every
kernel, then `{"ok": true, "device": {...}}`.  Without CUDA, or without
the package beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import subprocess
import sys
import tempfile
import time
import wave
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# Published peaks of an H100 SXM (NVIDIA data sheet): HBM3 bytes/s and
# dense bf16 tensor-core FLOP/s.  The bound of a kernel is the larger of
# its bytes over the first and its operations over the second.
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
# f32 on the CUDA cores (no tensor cores), printed beside the f32 kernels'
# bound; TF32 on the tensor cores, the ceiling of any f32 library reading; a
# third of it, the peak of the f32 kernels K1-K3 (three TF32 products per
# f32 product).
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_3XTF32_FLOPS = PEAK_TF32_FLOPS / 3
# A kernel or library reading implying more than this share of either peak
# is a fault of the measurement, and fails the run.
RATE_LIMIT = 1.05
# Graph timing: a write of twice the H100's 50 MB L2 before each call, and
# the best of this many replays.
L2_FLUSH_BYTES = 2 * 50 * 2 ** 20
GRAPH_REPLAYS = 3

# Flash kernel vs plain version in bf16: both round P to bf16 at different
# points and accumulate in different orders.
FLASH_RTOL, FLASH_ATOL = 2e-2, 2e-2
STATS_RTOL, STATS_ATOL = 1e-2, 1e-2
# Backward kernels (dq; dk, dv) vs their plain versions in bf16, from the
# same K1 residuals: both round P and dS to bf16, at values that differ in
# the last f32 bits, and sum in different orders.  Elementwise, and the
# relative L2 error of the whole tensor.
BWD_RTOL, BWD_ATOL = 2e-2, 2e-2
BWD_REL_L2 = 1e-2
# The f32 kernels vs their plain versions in f32: the forward
# (csrc/flash_attention_f32.cu) and the backward
# (csrc/flash_attention_bwd_f32.cu) keep about 21 bits a product (3xTF32);
# sums in other orders and exp's last bits (the cuda cases of
# tests/test_torch_flash.py).
FLASH_F32_RTOL, FLASH_F32_ATOL = 1e-4, 1e-5
BWD_F32_RTOL, BWD_F32_ATOL = 1e-4, 1e-4
BWD_F32_REL_L2 = 1e-5
# Small-model prefill vs its f32 CPU run, relative L2 error of the final
# hidden state over live rows: f32 on the card (TF32 off; the f32 K1's
# 3xTF32 products keep about 21 bits, and sums run in other orders), and
# bf16 on the card, whose rounding also flips a few router
# decisions (about 4e-2 through the plain bf16 path on the CPU); the flash
# path must be no less accurate than the einsum path, within 25 %.
PREFILL_F32_REL_L2 = 1e-3
PREFILL_BF16_REL_L2 = 1e-1
PREFILL_FLASH_VS_EINSUM = 1.25
# Small-model training loss and gradient in bf16 on the card vs the f32 CPU
# run, the same way: the loss's relative error, the relative L2 error of all
# parameter gradients together; the flash path's gradient no worse than
# 1.25 x the einsum path's.
TRAIN_LOSS_REL = 2e-2
TRAIN_GRAD_REL_L2 = 2e-1
TRAIN_FLASH_VS_EINSUM = 1.25
# The flagship training slice: the shape of the JAX package's train probe
# (`bench.py:85-128`): 4 layers at full width, B 4, T 2048; 1 warm-up step
# and TRAIN_TIMED_STEPS timed steps on one batch.
TRAIN_LAYERS, TRAIN_B, TRAIN_T = 4, 4, 2048
TRAIN_TIMED_STEPS = 5
# The training core (`run_train_core`): the flagship width cut to
# TRAIN_CORE_LAYERS layers, the train probe's batch, remat on.
#   - resume, bf16: k = TRAIN_CORE_K steps, a save, a new Trainer that
#     resumes, k more steps, against 2k steps straight through, twice (the
#     two uninterrupted runs are the path's own floor: where they agree bit
#     for bit, the resumed run must too; otherwise its parameters may differ
#     from the first by at most TRAIN_RESUME_VS_FLOOR x the floor);
#   - gradient accumulation, f32 (input jitter off and a constant aux-loss
#     weight, so that both micro-steps compute the same gradient; the f32
#     kernels K1-K3): two micro-steps of one batch (grad_accum_steps 2)
#     against one step of it; their mean is that batch's gradient, so the
#     parameters must agree to TRAIN_ACCUM_REL of the update's size
#     (relative L2 of the difference over the update; 0 where the path is
#     deterministic);
#   - the Gumbel / straight-through mixer, bf16: TRAIN_MIXER_STEPS steps;
#   - the export: save_pretrained of the resumed trainer, loaded by the
#     port's UniMoEAudio in bf16: the prefill's codec logits equal those of
#     the trainer's parameters cast as the loader casts them, bit for bit.
TRAIN_CORE_LAYERS = 2
TRAIN_CORE_K = 2
TRAIN_RESUME_VS_FLOOR = 4.0
TRAIN_ACCUM_REL = 1e-3
TRAIN_MIXER_STEPS = 2
# Vision training (`run_train_vision`): the flagship width cut to
# TRAIN_VISION_LAYERS decoder layers with the full 32-block tower, bf16,
# remat on; a batch of two image samples (seeded TRAIN_VISION_IMAGE x
# TRAIN_VISION_IMAGE numpy images: grid 1 x 32 x 32, 256 merged tokens
# each) and two text-only samples, made only by the port's data path;
# one warm-up and TRAIN_VISION_STEPS timed steps with the tower in the step.
TRAIN_VISION_LAYERS = 2
TRAIN_VISION_IMAGE = 448
TRAIN_VISION_STEPS = 3
# PEFT (`run_peft`): the flagship width cut to PEFT_LAYERS layers, bf16,
# the train probe's batch: one LoRA step (rank PEFT_LORA_RANK, alpha
# PEFT_LORA_ALPHA), one prefix-tuning and one P-tuning step (10 virtual
# tokens each); the merged LoRA model's greedy text_to_music; the f32
# witness, card vs CPU, greedy, PEFT_WITNESS_FRAMES frames with the prefix
# in the cache and with P-tuning's soft prompts: the first decode step's
# codec logits within PEFT_REF_REL_L2 and at least SERVE_REF_EQUAL_SHARE
# equal frames; surgery of a dense flagship-width model (F 11008 into
# experts of 2752 and 1376) and one step of the result; expert shards split
# and merged at each of PEFT_EP_SIZES, bit for bit.
PEFT_LAYERS = 2
PEFT_LORA_RANK, PEFT_LORA_ALPHA = 16, 32.0
PEFT_WITNESS_FRAMES = 32
PEFT_EP_SIZES = (2, 4, 8)
# The offload and stream trainers.  `check_small_offload_stream`: the
# flagship width cut to OFFLOAD_SMALL_LAYERS layers, f32 (so the f32 K1-K3
# launch), B OFFLOAD_SMALL_B x T OFFLOAD_SMALL_T, input jitter on, the same
# seeds, OFFLOAD_SMALL_STEPS steps each of `Trainer`, `OffloadTrainer` (f32
# moments) and `StreamTrainer` (f32 moments, lm_head trained): losses within
# OFFLOAD_LOSS_RTOL, gradient norms within OFFLOAD_GNORM_RTOL, parameters
# within OFFLOAD_PARAM_ATOL (the JAX package's stream-against-offload test,
# tests/test_stream.py:45-78) — the k_proj biases, whose gradient is zero up
# to rounding (softmax ignores a per-query shift of the scores), within
# 2 x the summed lr, as in tests/test_torch_train.py.  Two f32 stream runs
# are the path's floor: where they agree bit for bit, int8 moments' first
# step must equal the f32 step bit for bit (zero moments) and an int8 run of
# 2 steps + save + a new trainer from the checkpoint + 2 steps must equal 4
# straight; otherwise each difference may be TRAIN_ACCUM_REL of its updates
# (relative L2).
# The int8 run's second update against the f32 run's, leaf by leaf: the
# largest element's difference within INT8_STEP_ELEMENT of the leaf's
# largest f32 move (the JAX test's bound, tests/test_qmoment.py:98-133),
# the relative L2 within INT8_STEP_DRIFT (tools/int8_moment_drift.py reads
# about 0.035 at flagship width in the JAX package and the port alike) and,
# in the leaf that moves most, at least INT8_STEP_DRIFT_MIN: int8 moments
# that are not quantized at all read 0.  The stream trainer on the card
# against the CPU, `evaluate` with input jitter off: loss within
# OFFLOAD_CPU_LOSS_REL; the same forward with bf16 weights on the card is
# the control that must fail it.
OFFLOAD_SMALL_LAYERS = 2
OFFLOAD_SMALL_B, OFFLOAD_SMALL_T = 2, 256
OFFLOAD_SMALL_STEPS = 3
OFFLOAD_LOSS_RTOL, OFFLOAD_GNORM_RTOL, OFFLOAD_PARAM_ATOL = 2e-5, 1e-3, 5e-5
OFFLOAD_CPU_LOSS_REL = 1e-4
INT8_STEP_ELEMENT = 0.25
INT8_STEP_DRIFT = 0.1
INT8_STEP_DRIFT_MIN = 5e-3
# The 36-layer flagship through the offload trainers (`run_train_offload`,
# `run_train_stream`): bf16, dense dispatch, the train probe's batch, AdamW
# lr 1e-4, one warm-up and DEEP_TIMED_STEPS timed steps.  OffloadTrainer:
# f32 moments in host memory, remat.  StreamTrainer: int8 moments,
# DEEP_MICRO micro-batches a step, lm_head frozen (the JAX bench probe's
# configuration, bench.py:131-196); then the same at STREAM_SHALLOW_LAYERS
# layers for one step, whose peak is all that is read: the peak device
# memory may grow with depth by at most DEPTH_MARGIN x the extra layers'
# [B, T, D] bf16 boundary activations.  (The stream phase times one step
# after its warm-up: a second took about 9 s of the script's time limit.)
DEEP_TIMED_STEPS = 1
DEEP_MICRO = 2
STREAM_SHALLOW_LAYERS = 4
DEPTH_MARGIN = 1.25
# The sliding-window witness (`check_sliding_window`): SLIDING_LAYER_TYPES
# at flagship width, f32, window SLIDING_WINDOW; a greedy prefill of
# SLIDING_T_TEXT tokens and SLIDING_FRAMES frames, card vs CPU: the first
# decode step's codec logits within SLIDING_REL_L2, every frame equal, no
# K1 launch (flash is off for such a model).
SLIDING_LAYER_TYPES = ("sliding_attention", "full_attention")
SLIDING_WINDOW = 64
SLIDING_T_TEXT = 160
SLIDING_FRAMES = 32
SLIDING_REL_L2 = 1e-5
# The flagship gmm serving run's depth: a view of the first GMM_SERVING_LAYERS
# of the model's 36 layers (the serving path's width and captions).
GMM_SERVING_LAYERS = 12
# Extra T2M prefills timed after the main call.
PREFILL_REPEATS = 3
# Grouped GEMMs (K4, K4t, K5) vs their plain versions in bf16: both multiply
# bf16 values exactly and sum in f32 in other orders, and K4t and K5 round
# their sums to bf16.  The limits of K2 / K3, set before the first reading.
GMM_RTOL, GMM_ATOL = 2e-2, 2e-2
GMM_REL_L2 = 1e-2
# Small-model training through gmm: its gradient error vs the f32 CPU run no
# worse than 1.25 x the dense route's.
TRAIN_GMM_VS_DENSE = 1.25
# The flagship gmm training run's step 0 loss vs the dense run's, relative.
TRAIN_GMM_LOSS_REL = 1e-2
# Frames of the flagship gmm serving run, and of the short profiled runs
# that count device-to-host reads per decode step.
GMM_SERVING_FRAMES = 100
READS_FRAMES = 8
TURN_FRAMES = 12

# Quantized serving (int4 / int8 weights, a8 expert compute, the int8 KV
# cache).  The int4 run is the north star's configuration: QUANT_CAPTIONS
# captions of the T2M phase's lengths (prompt bucket 128), 64 CFG rows, so
# that decode takes packed_a8 at capacity 48 and the prefill packed_a8 at
# capacity 4,736; 10.24 s (512 frames), the shortest that text_to_music
# decodes through generate_chunked, so the int8 cache grows with its scales
# past the first 256-frame chunk.  The int8 run: the T2M phase's 4 captions,
# QUANT_INT8_SECONDS.
QUANT_CAPTIONS = 32
QUANT_INT4_SECONDS = 10.24
QUANT_INT8_SECONDS = 1.2
# The quantized reference check, card vs CPU: a 2-layer model at flagship
# width in f32 with int8 weights.  Through packed dispatch and an f32 cache
# only the summation order differs: relative L2 of the codec logits under
# QUANT_REF_EXACT_REL_L2.  With a8 and the int8 cache a value within an ulp
# of a half step of its int8 grid rounds either way, and each such flip
# moves a product or a cached key by a whole step, so last-bit differences
# grow to about 1e-2 of the logits.  The card must stay within
# QUANT_REF_VS_NOISE x the CPU's own move when its input embeddings change
# by a relative QUANT_REF_NOISE, measured in the same run, and under
# QUANT_REF_REL_L2.
QUANT_REF_EXACT_REL_L2 = 1e-4
QUANT_REF_NOISE = 1e-7
QUANT_REF_VS_NOISE = 5.0
QUANT_REF_REL_L2 = 1e-1
# int4-gptq at full width, cut to this many layers.
GPTQ_LAYERS = 4
# Greedy frames generated before and after the snapshot round trip (more
# than the flagship's largest delay, 18, so every stream has frames).
SNAPSHOT_FRAMES = 24

# Voice-clone TTS on the flagship: a TTS_PROMPT_SECONDS two-tone reference
# wav at TTS_PROMPT_SR (150 codec frames, so the prompt buckets to 256
# tokens), four target sentences, cfg_scale 1.0 (the TTS default),
# TTS_SECONDS of audio at most.
TTS_PROMPT_SECONDS = 3.0
TTS_PROMPT_SR = 22050
TTS_SECONDS = 5
TTS_PROMPT_TEXT = "The quick brown fox jumps over the lazy dog near the river bank."
TTS_SENTENCES = [
    "Good morning.",
    "The weather today is calm and clear across the whole valley.",
    "Please remember to bring the blue folder to the meeting this afternoon.",
    "She walked slowly along the quiet beach while the sun set behind the hills and gulls "
    "circled overhead.",
]
# The DAC encode of the prompt, card vs CPU: the least share of equal codes.
DAC_ENCODE_EQUAL_SHARE = 0.99
# The 2-layer f32 voice-clone prefill, card vs CPU: the exact f32 path's
# limit of the quantized reference check (sums in other orders, and the f32
# K1's 3xTF32 products, about 21 bits each).
VOICE_REF_REL_L2 = QUANT_REF_EXACT_REL_L2
# Streaming T2M: 2 s at most, in chunks of 25 frames.
STREAM_FRAMES = 100
STREAM_CHUNK = 25
# Video+text-to-music on the flagship with its full vision tower: four
# pre-extracted videos (float frames in [0, 255] from seed 0) [T, 3, H, W],
# each with a caption of the T2M phase's lengths; cfg_scale 10 (the VT2M
# default), VT2M_SECONDS of audio at most, VT2M_MIN_SECONDS at least.
#   A: a square clip at the video pixel cap (64 x 28 x 28 = 224 x 224),
#      grid (2, 16, 16), 128 video tokens, 8 windows;
#   B: a 720p 16:9 frame after smart_resize at that cap, an odd frame count
#      (the last frame repeated), grid (2, 12, 20), 120 tokens, ragged
#      windows;
#   C: one frame (the reference API's max_frames=1), grid (1, 8, 8), 16
#      tokens;
#   D: an array above the cap, which the API takes as it is, grid
#      (1, 24, 24), 144 tokens.
VT2M_VIDEOS = {"A": (4, 3, 224, 224), "B": (3, 3, 168, 280), "C": (1, 3, 112, 112),
               "D": (2, 3, 336, 336)}
VT2M_TOKENS = {"A": 128, "B": 120, "C": 16, "D": 144}
VT2M_CAPTION_WORDS = (58, 74, 90, 106)
VT2M_SECONDS = 5
VT2M_MIN_SECONDS = 3
# The reference checks, card vs CPU in f32 (TF32 off; sums in other orders,
# and the f32 K1's 3xTF32 products, about 21 bits each), relative L2: the
# tower at full width cut to VT2M_REF_DEPTH blocks (so that it holds
# full-attention block 7) on video B, and a 2-layer
# flagship-width VT2M prefill fed by that tower on videos B and C (codec
# logits) — the exact f32 path's limit of the other reference checks.  The
# prefill's two runs take the same routing: the CPU routes every token as
# the card did (its top-p counts, and its mixer decided from the card's
# router logits), and its own router logits are held to the same limit.
# Eight routed experts, a top-p count and a near-set cut (the eval mixer's
# 2 x router_jitter_noise) make discrete decisions that a 1e-6 difference
# flips where a token sits on a boundary; the development tokenizer's word
# ids come from the per-process salted hash(), so each run feeds other ids
# (tools/vt2m_router_sweep.py: which salts flip a decision, their margins,
# and an f64 witness).  The tokens that the CPU's own logits would route
# otherwise are counted and printed: a count or an expert set that differs,
# or a routing weight that moves by more than ROUTE_WEIGHT_JUMP (the
# near-set cut's jumps; continuous moves are about 1e-6).
VT2M_REF_DEPTH = 8
VT2M_REF_REL_L2 = QUANT_REF_EXACT_REL_L2
ROUTE_WEIGHT_JUMP = 1e-3
# The int8 serving phase's short VT2M call: videos A and C, 1 s.
VT2M_INT8_VIDEOS = ("A", "C")
VT2M_INT8_SECONDS = 1

# The serving apps on the flagship (`run_serving_apps`).
#   Mixed batch: one generate_mixed call, sampled, a seed per request:
#   two T2M requests (cfg 10 and 5; 1 s and 3 s), a voice-clone TTS request
#   on the TTS phase's 3 s prompt (2 s) and a VT2M request on video C (2 s).
MIXED_T2M = ((10.0, 1.0, 58), (5.0, 3.0, 74))     # (cfg_scale, seconds, caption words)
MIXED_TTS_SECONDS = 2.0
MIXED_VT2M_SECONDS = 2.0
#   Continuous: a deterministic (dense) SlotServer of SERVE_SLOTS slots,
#   t_text SERVE_T_TEXT, a SERVE_HORIZON-frame decode region and chunks of
#   SERVE_CHUNK frames; greedy.  Four T2M requests of SERVE_T2M_SECONDS
#   first (their minimum is their budget, so they end at frames 50, 75,
#   100 and at most 125); after the first chunk a VT2M request (video C)
#   and a TTS request on the 3 s prompt.  The VT2M request takes the first
#   slot that frees (frame 64).  The TTS request's budget is set so that it
#   does not fit the horizon at the second (frame 96) but fits 32 frames
#   lower: on the flagship 283 frames (96 + 283 + 19 prompt frames + 18
#   delay + 2 > 402 buffer frames).  It waits until the T2M rows retire at
#   frame 128, when the server compacts the dead prefix below the VT2M row
#   (64 frames) and admits it at frame 64.
SERVE_SLOTS, SERVE_T_TEXT, SERVE_HORIZON, SERVE_CHUNK = 4, 256, 400, 32
SERVE_T2M_SECONDS = (1.0, 1.5, 2.0, 2.5)
SERVE_VT2M_SECONDS = 2.0
#   The reference checks of the serving apps run a 2-layer flagship-width
#   f32 model on the card (weights from seed 3; `check_serving_reference`),
#   at the serving shapes, so that every prefill takes the f32 K1:
#   - a mixed batch of the mixed phase's four tasks (the TTS request on a
#     prompt of SERVE_REF_TTS_FRAMES codec frames, so that the batch's
#     T_text is 256 as the flagship's), sampled, a seed each, short,
#     against each request alone through generate_mixed (T_text 128 or
#     256): the witness that a seeded request's draws do not depend on its
#     batch on the card, printed beside the flagship's bf16 shares;
#   - the continuous schedule at half the scale (chunks of
#     SERVE_REF_CHUNK, horizon SERVE_REF_HORIZON, the T2M rows retiring 2,
#     3 and 4 chunks in) at the flagship's t_text 256, so that it compacts
#     as the flagship's does, against each request decoded alone by
#     `generate` on the card;
#   - `text_to_music_speculative` (spec_len SPEC_LEN, one draft layer) on a
#     caption that buckets to 128 against greedy `text_to_music(
#     decode_emit=False)`, SERVE_REF_SPEC_SECONDS: equal lengths, the
#     decoded frames equal to the baseline's steps, between
#     ceil(frames / spec_len) and frames cycles.
#   Each is gated on the least share of equal frames (codec frames of the
#   delayed domain, up to each request's span).  The first reading of the
#   continuous one on an H100 was 1.0000; the bound tolerates a late
#   reduction-order flip of a near-tied argmax in one request, not an early
#   divergence.
SERVE_REF_SECONDS = (0.6, 0.8, 1.0, 1.2, 0.8)  # 4 T2M, VT2M; the late TTS from the horizon
SERVE_REF_HORIZON, SERVE_REF_CHUNK = 160, 16
SERVE_REF_EQUAL_SHARE = 0.95
SERVE_REF_TTS_FRAMES = 150
SERVE_REF_SPEC_SECONDS = 1.0
#   Speculative: one caption, SPEC_SECONDS, spec_len SPEC_LEN, the first
#   SPEC_DRAFT_LAYERS layers as the draft; against greedy text_to_music
#   with decode_emit=False on the same prompt.
SPEC_SECONDS, SPEC_LEN, SPEC_DRAFT_LAYERS = 2.0, 4, 9
#   Time to first audio: TTFA_TRIALS timed calls after a first one.
TTFA_TRIALS = 5
#   The studio: one POST /api/generate of STUDIO_SECONDS of music.
STUDIO_SECONDS = 1.0
# The PEFT f32 witness (`run_peft`): the exact f32 path's limit, as the
# voice-clone and VT2M witnesses hold theirs.
PEFT_REF_REL_L2 = QUANT_REF_EXACT_REL_L2

# The parallel paths at world size 1 (`run_export`, `run_mesh_serving`,
# `run_mesh_training`): the flagship width cut to MESH_LAYERS layers.  The
# export is written in bf16 and reloaded; MESH_PROMPTS T2M captions decode
# MESH_FRAMES greedy frames from the source, the reload and the mesh (one
# rank, NCCL); the mesh trainer (fsdp on) takes MESH_TRAIN_STEPS steps on
# the train probe's batch beside a mesh-less one.  `timeit_in_jit` must
# read one K1 launch at the training shape within TIMEIT_VS_GRAPH of
# `graph_ms`.
MESH_LAYERS = 4
MESH_PROMPTS = 4
MESH_FRAMES = 16
MESH_TRAIN_STEPS = 2
TIMEIT_VS_GRAPH = 0.10
# Sequence and pipeline parallelism at world size 1 (`run_ring`,
# `run_pipeline`), bf16 at the flagship width.  The ring's chunk arithmetic
# composed over RING_CHUNKS virtual ranks at B 1 x T RING_T (one process,
# each rank's queries visiting the chunks in ring order) is held to K1 over
# the whole T with K1's own bf16 tolerance: both round P to bf16, at other
# points, and sum in other orders.  `ring_attention` on its group of one
# rank is held to K1 at the training shape the same way.  The ring trainers
# (`ring_axis` "model", "data" and "expert", the mesh trainer's cut) keep
# their losses within TRAIN_LOSS_REL of the mesh-less trainer's.  `pipeline_forward` at one
# stage and PIPE_MICRO microbatches of the train probe's batch: its hidden
# states equal `text_model_forward(use_flash=False)` of each microbatch bit
# for bit (the same products at the same shapes), and against one forward
# of the whole batch, where bf16 products over another row count round
# otherwise and move a few top-p routing decisions (ROADMAP §3), the hidden
# states are within PIPE_HIDDEN_REL_L2 and the parameters' gradients
# within PIPE_GRAD_REL_L2, relative L2 (about 2 x the first readings,
# 1.394e-2 and 2.252e-2).
RING_T, RING_CHUNKS = 16384, 8
RING_RTOL, RING_ATOL = FLASH_RTOL, FLASH_ATOL
PIPE_MICRO = 4
PIPE_HIDDEN_REL_L2 = 3e-2
PIPE_GRAD_REL_L2 = 5e-2

KERNEL_SOURCES = ("flash_attention_fwd", "flash_attention_bwd", "flash_attention_f32",
                  "flash_attention_bwd_f32", "grouped_gemm")
GROUPED = ("grouped_gemm_gmm", "grouped_gemm_gmm_transposed", "grouped_gemm_tgmm")

WORDS = ("warm analog synth pads drift over a slow hip hop beat with dusty vinyl "
         "crackle mellow electric piano chords deep sub bass and soft brushed "
         "drums while a distant saxophone plays a lazy melody in a minor key").split()


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def caption(n_words: int) -> str:
    return " ".join(WORDS[i % len(WORDS)] for i in range(n_words))


def _t2m_prompts(captions) -> list:
    """The CFG-paired prompt rows text_to_music makes of these captions."""
    from unimoe_audio_torch.api import T2M_NEGATIVE_CAPTION, t2m_prompt

    neg = t2m_prompt(T2M_NEGATIVE_CAPTION)
    return [x for c in captions for x in (neg, t2m_prompt(c))]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of fn over iters launches, from CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int):
    """Device time per call of fn, from CUDA events around the replay of a
    CUDA graph that holds `iters` calls, each after a write of
    L2_FLUSH_BYTES (so every call finds the L2 cold, as its caller would
    in a forward pass); the replay time of a graph of the writes alone is
    subtracted.  A replay has no host gaps between the launches and no
    profiler windows.  The best of GRAPH_REPLAYS replays of each graph.
    None, with the reason printed, when fn cannot be captured."""
    import torch

    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):                  # warm-up outside the capture
            fn()
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graphs = []
        for with_fn in (True, False):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                for _ in range(iters):
                    flush.zero_()
                    if with_fn:
                        fn()
            graphs.append(g)
    except Exception as e:                              # noqa: BLE001 — reported, not hidden
        print(f"graph timing: capture failed ({type(e).__name__}: {e}); not measured",
              flush=True)
        return None
    best = []
    for g in graphs:
        g.replay()
        times = []
        for _ in range(GRAPH_REPLAYS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            g.replay()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        best.append(min(times))
    del graphs
    return (best[0] - best[1]) / iters


def check_rate(label: str, ms, nbytes: float, flops: float,
               peak_flops: float = PEAK_BF16_FLOPS) -> None:
    """Fail when a reading of ms for a call that must move nbytes and do
    flops (at peak_flops: bf16 tensor cores by default) implies more than
    RATE_LIMIT x the card's peak rate of either: such a reading is a fault
    of the measurement."""
    if ms is None:
        return
    check(ms > 0, f"{label}: reading {ms} ms is not positive")
    check(flops / (ms * 1e-3) <= RATE_LIMIT * peak_flops
          and nbytes / (ms * 1e-3) <= RATE_LIMIT * PEAK_BYTES_PER_S,
          f"{label}: {ms:.4f} ms for {flops / 1e9:.3f} GFLOP and {nbytes / 1e6:.2f} MB is "
          f"{flops / ms / 1e9:.1f} TFLOP/s and {nbytes / ms / 1e9:.3f} TB/s, above "
          f"{RATE_LIMIT:.0%} of the peak ({peak_flops / 1e12:.0f} TFLOP/s, "
          f"{PEAK_BYTES_PER_S / 1e12:.2f} TB/s)")


def flash_inputs(B, H, KV, T, S, Dh, valid, seed, dtype=None):
    import torch

    dtype = dtype or torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, H, T, Dh, generator=gen, device="cuda").mul_(0.5).to(dtype)
    k = torch.randn(B, KV, S, Dh, generator=gen, device="cuda").mul_(0.5).to(dtype)
    v = torch.randn(B, KV, S, Dh, generator=gen, device="cuda").to(dtype)
    return q, k, v, torch.as_tensor(valid, dtype=torch.int32, device="cuda").contiguous()


def allowed_mask(valid, T, S, causal=True):
    import torch

    tri = torch.ones(T, S, dtype=torch.bool, device=valid.device).tril(S - T if causal else S)
    return (valid[:, None, :] > 0) & tri                                  # [B, T, S]


def check_flash(B, H, KV, T, S, Dh, pads, seed, causal=True, valid=None, dtype=None) -> float:
    """Kernel vs plain version, in bf16 (the default) or f32 (the f32
    kernel, counted by its own counter, launched twice for equal bits);
    dead rows exactly 0.  Returns max |err|.  The keys' validity is `pads`
    left pads per row, or the mask `valid` [B, S] where it is given."""
    import torch
    from unimoe_audio_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference)

    f32 = dtype == torch.float32
    rtol, atol = (FLASH_F32_RTOL, FLASH_F32_ATOL) if f32 else (FLASH_RTOL, FLASH_ATOL)
    srtol, satol = (FLASH_F32_RTOL, FLASH_F32_ATOL) if f32 else (STATS_RTOL, STATS_ATOL)
    if valid is None:
        valid = np.ones((B, S), np.int32)
        for b, p in enumerate(pads):
            valid[b, :p] = 0
    q, k, v, vt = flash_inputs(B, H, KV, T, S, Dh, valid, seed, dtype)
    counts = _launch_counts()
    o, m, l = flash_attention(q, k, v, vt, causal=causal, return_stats=True)
    again = flash_attention(q, k, v, vt, causal=causal, return_stats=True) if f32 else None
    torch.cuda.synchronize()
    key = "flash_attention_fwd_f32" if f32 else "flash_attention_fwd"
    check(_launch_counts()[key] == counts[key] + 1 + f32, f"check_flash: no {key} launch")
    ro, rm, rl = flash_attention_reference(q, k, v, vt, causal, return_stats=True)
    o32, r32 = o.float(), ro.float()
    name = (f"flash{' f32' if f32 else ''} B={B} H={H} KV={KV} T={T} S={S} Dh={Dh} "
            f"causal={causal} pads={list(pads)}")
    check(bool(torch.isfinite(o32).all()), f"{name}: non-finite output")
    check(bool(((o32 - r32).abs() <= atol + rtol * r32.abs()).all()),
          f"{name}: output differs from the plain version, max err "
          f"{(o32 - r32).abs().max().item()}")
    check(bool(((m - rm).abs() <= satol + srtol * rm.abs()).all()), f"{name}: m differs")
    check(bool(((l - rl).abs() <= satol + srtol * rl.abs()).all()), f"{name}: l differs")
    if f32:
        check(all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                  for a, b in zip((o, m, l), again)),
              f"{name}: two launches on the same inputs differ")
    dead = ~allowed_mask(vt, T, S, causal).any(-1)                        # [B, T]
    dead_rows = int(dead.sum()) * H
    dead_bht = dead[:, None, :].expand(B, H, T)
    check(bool((o32.abs().sum(-1)[dead_bht] == 0).all())
          and bool((m.view(B, H, T)[dead_bht] == -1e30).all())
          and bool((l.view(B, H, T)[dead_bht] == 1e30).all()),
          f"{name}: a dead row is not exactly 0 with m = -1e30 and l = 1e30")
    err = (o32 - r32).abs().max().item()
    print(f"kernel check: {name}: max|err| {err:.3e} (rtol {rtol}, atol {atol}); "
          f"{dead_rows} dead rows exactly 0 (m -1e30, l 1e30)"
          + ("; a second launch bit-identical" if f32 else ""),
          flush=True)
    return err


def bwd_inputs(B, H, KV, T, S, Dh, pads, causal, seed, dtype=None):
    """Inputs of the backward kernels as the training path makes them: q, k,
    v, kv_valid, dO, and K1's residuals m, l with D = rowsum(dO * O)."""
    import torch
    from unimoe_audio_torch.ops.flash_attention import flash_attention, softmax_residual_rowsum

    valid = np.ones((B, S), np.int32)
    for b, p in enumerate(pads):
        valid[b, :p] = 0
    q, k, v, vt = flash_inputs(B, H, KV, T, S, Dh, valid, seed, dtype)
    gen = torch.Generator(device="cuda").manual_seed(seed + 100)
    do = torch.randn(B, H, T, Dh, generator=gen, device="cuda").to(q.dtype)
    counts = _launch_counts()
    o, m, l = flash_attention(q, k, v, vt, causal=causal, return_stats=True)
    _set_launch_counts(counts)                         # not a launch of the main path
    return q, k, v, do, m, l, softmax_residual_rowsum(do, o), vt


def check_flash_bwd(B, H, KV, T, S, Dh, pads, causal, seed, dtype=None) -> dict:
    """The dq and dk/dv kernels vs their plain versions on the same inputs,
    in bf16 (the default) or f32 (the f32 kernels); dq of dead rows exactly
    0; a second launch on the same inputs gives the same bits.  Returns max
    |err| of dq, dk and dv."""
    import torch
    from unimoe_audio_torch.ops import flash_attention as FA

    f32 = dtype == torch.float32
    rtol, atol, rel_l2 = ((BWD_F32_RTOL, BWD_F32_ATOL, BWD_F32_REL_L2) if f32
                          else (BWD_RTOL, BWD_ATOL, BWD_REL_L2))
    args = bwd_inputs(B, H, KV, T, S, Dh, pads, causal, seed, dtype)
    counts = _launch_counts()
    dq = FA.flash_attention_bwd_dq(*args, causal)
    dk, dv = FA.flash_attention_bwd_dkv(*args, causal)
    dq2 = FA.flash_attention_bwd_dq(*args, causal)
    dk2, dv2 = FA.flash_attention_bwd_dkv(*args, causal)
    torch.cuda.synchronize()
    key = "flash_attention_bwd_dq" + ("_f32" if f32 else "")
    check(_launch_counts()[key] == counts[key] + 2, f"check_flash_bwd: {key} was not launched")
    _set_launch_counts(counts)                  # not launches of a main path
    rdq = FA.flash_attention_bwd_dq_reference(*args, causal)
    rdk, rdv = FA.flash_attention_bwd_dkv_reference(*args, causal)
    name = (f"flash bwd{' f32' if f32 else ''} B={B} H={H} KV={KV} T={T} S={S} Dh={Dh} "
            f"causal={causal} pads={list(pads)}")
    errs, rels = {}, {}
    for label, got, want in (("dq", dq, rdq), ("dk", dk, rdk), ("dv", dv, rdv)):
        g32, w32 = got.float(), want.float()
        check(bool(torch.isfinite(g32).all()), f"{name}: non-finite {label}")
        err = (g32 - w32).abs()
        rel = ((g32 - w32).norm() / w32.norm().clamp_min(1e-30)).item()
        check(bool((err <= atol + rtol * w32.abs()).all()) and rel <= rel_l2,
              f"{name}: {label} differs from the plain version, max err {err.max().item()}, "
              f"relative L2 {rel}")
        errs[label], rels[label] = err.max().item(), rel
    bits = torch.int32 if f32 else torch.int16
    check(all(torch.equal(a.view(bits), b.view(bits))
              for a, b in ((dq, dq2), (dk, dk2), (dv, dv2))),
          f"{name}: two launches on the same inputs differ")
    dead = ~allowed_mask(args[-1], T, S, causal).any(-1)                 # [B, T]
    dead_rows = int(dead.sum()) * H
    check(bool((dq.float().abs().sum(-1)[dead[:, None, :].expand(B, H, T)] == 0).all()),
          f"{name}: dq of a dead row is not exactly 0")
    print(f"kernel check: {name}: " + ", ".join(
        f"{lab} max|err| {errs[lab]:.3e} rel L2 {rels[lab]:.2e}" for lab in errs)
        + f" (rtol {rtol}, atol {atol}, rel L2 {rel_l2}); "
        f"{dead_rows} dead rows with dq exactly 0; a second launch bit-identical", flush=True)
    return errs


def _rel(a, b) -> float:
    return ((a - b).norm() / b.norm()).item()


def _to(tree, **kw):
    if isinstance(tree, dict):
        return {k: _to(v, **kw) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, **kw) for v in tree]
    if isinstance(tree, tuple):                   # a QTensor: q and s
        return type(tree)(*(_to(v, **kw) for v in tree))
    return tree.detach().to(**kw)


def check_small_prefill() -> None:
    """A 2-layer model with head_dim 128, one set of weights, held against
    its f32 prefill on the CPU (the path the parity tests hold against
    JAX): the f32 prefill on the card, and the bf16 prefill on the card
    through the flash kernel and through the einsum path.  Relative L2
    error of the final hidden state over live rows."""
    import torch
    from unimoe_audio_torch.config import tiny_test_config
    from unimoe_audio_torch.models import model as M
    from unimoe_audio_torch.models.layers import KVCache
    from unimoe_audio_torch.ops.flash_attention import flash_attention

    cfg = tiny_test_config(hidden_size=512, num_attention_heads=4, num_key_value_heads=2,
                           vocab_size=512)
    tc = cfg.text_config
    cpu = M.init_model_params(cfg, seed=1, dtype=torch.float32, device="cpu")

    B, T = 4, 128
    rng = np.random.default_rng(0)
    ids = rng.integers(0, tc.vocab_size - 8, size=(B, T))
    mask = np.ones((B, T), np.int64)
    for b, p in enumerate((0, 100, 17, 64)):
        mask[b, :p] = 0
    pos = np.where(mask == 0, 1, np.cumsum(mask, -1) - 1)
    live = torch.as_tensor(mask, dtype=torch.bool)

    def prefill(device, dtype, flash):
        params = cpu if device == "cpu" else _to(cpu, device=device, dtype=dtype)
        ids_t = torch.as_tensor(ids, device=device)
        mask_t = torch.as_tensor(mask, dtype=torch.int32, device=device)
        pos_t = torch.as_tensor(pos, device=device)[None].expand(3, B, T)
        cache = KVCache.create(tc.num_hidden_layers, B, T, tc.num_key_value_heads, tc.head_dim,
                               dtype=dtype, device=device)
        emb = M.calculate_input_embedding(params, ids_t, None, cfg.codec_placeholder_value)
        out = M.text_model_forward(params, emb, pos_t, tc, kv_cache=cache, cache_position=0,
                                   kv_valid_mask=mask_t, padding_token_mask=mask_t,
                                   use_flash=flash)
        h = out.last_hidden_state.float().cpu()
        check(bool(torch.isfinite(h).all()), f"small prefill {device} {dtype}: non-finite")
        return h[live]

    with torch.inference_mode():
        ref = prefill("cpu", torch.float32, False)
        f32_err = _rel(prefill("cuda", torch.float32, False), ref)
        einsum_err = _rel(prefill("cuda", torch.bfloat16, False), ref)
        before = flash_attention.launches
        flash_err = _rel(prefill("cuda", torch.bfloat16, True), ref)
        check(flash_attention.launches == before + tc.num_hidden_layers,
              "small prefill did not go through the flash kernel")
    check(f32_err < PREFILL_F32_REL_L2, f"f32 prefill, card vs CPU: relative L2 {f32_err}")
    check(flash_err < PREFILL_BF16_REL_L2 and flash_err <= PREFILL_FLASH_VS_EINSUM * einsum_err,
          f"bf16 prefill vs f32: flash {flash_err}, einsum {einsum_err}")
    print(f"reference check: 2-layer prefill vs f32 on the CPU, live rows, relative L2 error: "
          f"f32 card {f32_err:.3e} (limit {PREFILL_F32_REL_L2}); bf16 card through the flash "
          f"kernel {flash_err:.3e}, through the einsum path {einsum_err:.3e} (limits "
          f"{PREFILL_BF16_REL_L2}, and flash <= {PREFILL_FLASH_VS_EINSUM} x einsum)", flush=True)


def _small_batch(cfg, B: int, T: int, start: int):
    """The small training checks' batch, B 4 x T: left pads (0, 100, 17,
    64), codec placeholders from position `start`, codec labels from there
    on.  A label is predicted from the row before it, so it is kept only
    where that row is live too: a fully padded row is 0 through flash and a
    uniform average through the einsum path, by design."""
    tc, C = cfg.text_config, cfg.codec_channels
    rng = np.random.default_rng(0)
    ids = rng.integers(0, tc.vocab_size - 8, size=(B, T))
    ids[:, start:] = cfg.codec_placeholder_value
    mask = np.ones((B, T), np.int64)
    for b, p in enumerate((0, 100, 17, 64)):
        mask[b, :p] = 0
    codec = rng.integers(0, cfg.codec_eos_value, size=(B, T, C))
    live = (mask == 1) & np.concatenate([np.zeros((B, 1), bool), mask[:, :-1] == 1], 1)
    labels = np.where(live[..., None] & (np.arange(T) >= start)[None, :, None], codec, -100)
    return {"input_ids": ids, "codec_input_ids": codec, "attention_mask": mask,
            "codec_labels": labels,
            "aux_balance_weight": np.where(labels[..., 0] != -100, 10.0, 1.0).astype(np.float32)}


def check_small_training() -> None:
    """A 2-layer model with head_dim 128 (input jitter off: the CPU and the
    card draw different noise), one `loss_fn` value and gradient with remat
    on, B 4 x T 128 with left padding: in bf16 on the card through the flash
    kernels and through the einsum path (use_flash=False), and through the
    flash kernels with gmm dispatch (the grouped GEMMs), each held against
    the f32 run on the CPU (the path the parity tests hold against JAX)."""
    import torch
    from unimoe_audio_torch.config import tiny_test_config
    from unimoe_audio_torch.models import model as M
    from unimoe_audio_torch.ops import flash_attention as FA
    from unimoe_audio_torch.train import step as TS

    cfg = tiny_test_config(hidden_size=512, num_attention_heads=4, num_key_value_heads=2,
                           vocab_size=512, input_jitter_noise=0.0)
    tc = cfg.text_config
    cpu = M.init_model_params(cfg, seed=1, dtype=torch.float32, device="cpu")
    batch = _small_batch(cfg, 4, 128, start=8)

    def loss_and_grad(device, dtype, use_flash, dispatch_mode="dense"):
        params = _to(cpu, device=device, dtype=dtype)
        TS.init_train_state(params, TS.make_optimizer())
        tb = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        loss, _ = TS.loss_fn(params, cfg, tb, 0, 0.025, remat=True, use_flash=use_flash,
                             dispatch_mode=dispatch_mode)
        leaves = [t for _, t in TS.named_leaves(params)]
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)   # lm_head is unused
        flat = torch.cat([(torch.zeros_like(t) if g is None else g).float().flatten().cpu()
                          for t, g in zip(leaves, grads)])
        check(bool(torch.isfinite(loss)) and bool(torch.isfinite(flat).all()),
              f"small training {device} {dtype}: non-finite loss or gradient")
        return loss.item(), flat

    ref_loss, ref_grad = loss_and_grad("cpu", torch.float32, None)
    einsum_loss, einsum_grad = loss_and_grad("cuda", torch.bfloat16, False)
    before = (FA.flash_attention.launches, FA.flash_attention_bwd_dq.launches,
              FA.flash_attention_bwd_dkv.launches)
    flash_loss, flash_grad = loss_and_grad("cuda", torch.bfloat16, None)
    after = (FA.flash_attention.launches, FA.flash_attention_bwd_dq.launches,
             FA.flash_attention_bwd_dkv.launches)
    L = tc.num_hidden_layers
    check(tuple(a - b for a, b in zip(after, before)) == (2 * L, L, L),
          f"small training did not go through the flash kernels: launches {before} -> {after}")
    e_loss = abs(einsum_loss - ref_loss) / abs(ref_loss)
    f_loss = abs(flash_loss - ref_loss) / abs(ref_loss)
    e_grad, f_grad = _rel(einsum_grad, ref_grad), _rel(flash_grad, ref_grad)
    check(max(e_loss, f_loss) < TRAIN_LOSS_REL, f"bf16 training loss vs f32: flash {f_loss}, "
          f"einsum {e_loss} (limit {TRAIN_LOSS_REL})")
    check(f_grad < TRAIN_GRAD_REL_L2 and f_grad <= TRAIN_FLASH_VS_EINSUM * e_grad,
          f"bf16 training gradient vs f32: flash {f_grad}, einsum {e_grad}")
    counts = _launch_counts()
    gmm_loss, gmm_grad = loss_and_grad("cuda", torch.bfloat16, None, "gmm")
    g_launch = {k: v - counts[k] for k, v in _launch_counts().items() if k in GROUPED}
    want = dict(zip(GROUPED, (6 * L, 3 * L, 3 * L)))    # 3 projections; remat recomputes
    check(g_launch == want, f"small gmm training launches {g_launch}, want {want}")
    g_loss = abs(gmm_loss - ref_loss) / abs(ref_loss)
    g_grad = _rel(gmm_grad, ref_grad)
    check(g_loss < TRAIN_LOSS_REL and g_grad < TRAIN_GRAD_REL_L2
          and g_grad <= TRAIN_GMM_VS_DENSE * f_grad,
          f"bf16 gmm training vs f32: loss {g_loss}, gradient {g_grad} (dense {f_grad})")
    print(f"reference check: 2-layer training loss and gradient, bf16 card vs f32 CPU: loss "
          f"{ref_loss:.5f} (f32), relative error flash {f_loss:.3e}, einsum {e_loss:.3e} "
          f"(limit {TRAIN_LOSS_REL}); gradient relative L2 flash {f_grad:.3e}, einsum "
          f"{e_grad:.3e} (limits {TRAIN_GRAD_REL_L2}, and flash <= {TRAIN_FLASH_VS_EINSUM} x "
          f"einsum); flash launches fwd/dq/dkv {tuple(a - b for a, b in zip(after, before))}",
          flush=True)
    print(f"reference check: the same through gmm dispatch: loss relative error {g_loss:.3e}, "
          f"gradient relative L2 {g_grad:.3e} (limit {TRAIN_GMM_VS_DENSE} x dense {f_grad:.3e}); "
          f"grouped launches {g_launch}", flush=True)


def check_small_vision_peft_training() -> None:
    """check_small_training's 2-layer model (head_dim 128, input jitter
    off, B 4 x T 128 with left pads) with the tiny vision tower: one
    `loss_fn` value and gradient with remat on, in bf16 on the card through
    the flash kernels, each held against the f32 run on the CPU at
    TRAIN_LOSS_REL / TRAIN_GRAD_REL_L2: an image batch prepared as
    `Trainer._prepare_vision_batch` does with train_vision (two images,
    grids 1 x 8 x 8 and 1 x 4 x 8; the tower's leaves in the gradient);
    prefix tuning (10 virtual tokens: K1, K2 and K3 launched exactly 2L, L
    and L times, every K1 over S = T + 10 keys); LoRA on the four attention
    projections (b drawn, so that every LoRA leaf has a gradient; their
    gradient held on its own too)."""
    import types

    import torch
    from unimoe_audio_torch.config import tiny_test_config
    from unimoe_audio_torch.models import model as M
    from unimoe_audio_torch.ops import flash_attention as FA
    from unimoe_audio_torch.train import lora as LO
    from unimoe_audio_torch.train import peft as PE
    from unimoe_audio_torch.train import step as TS
    from unimoe_audio_torch.train.trainer import Trainer, TrainerConfig

    cfg = tiny_test_config(hidden_size=512, num_attention_heads=4, num_key_value_heads=2,
                           vocab_size=512, input_jitter_noise=0.0, with_vision=True)
    tc, vcfg = cfg.text_config, cfg.vision_config
    L = tc.num_hidden_layers
    B, T = 4, 128
    base = M.init_model_params(cfg, seed=1, dtype=torch.float32, device="cpu", with_vision=True)
    text = _small_batch(cfg, B, T, start=40)

    # The image rows: row 0 (no pads) and row 2 (17 pads), each a vision span
    # ahead of the codec placeholders.
    grids = np.array([[1, 8, 8], [1, 4, 8]])
    m2 = vcfg.spatial_merge_size ** 2
    img = {k: v.copy() for k, v in text.items()}
    for b, start, grid in ((0, 1, grids[0]), (2, 19, grids[1])):
        n = int(grid.prod()) // m2
        img["input_ids"][b, start] = cfg.vision_start_token_id
        img["input_ids"][b, start + 1:start + 1 + n] = cfg.image_token_id
        img["input_ids"][b, start + 1 + n] = cfg.vision_end_token_id
    patch_dim = vcfg.in_channels * vcfg.temporal_patch_size * vcfg.patch_size ** 2
    img["pixel_values"] = np.random.default_rng(1).normal(
        size=(int(grids.prod(1).sum()), patch_dim)).astype(np.float32)
    img["image_grid_thw"] = grids
    host = types.SimpleNamespace(cfg=cfg, tcfg=TrainerConfig(), device=torch.device("cpu"),
                                 state=types.SimpleNamespace(params=base))
    img = Trainer._prepare_vision_batch(host, img)

    prefix = {**base, "peft": PE.init_prefix_tuning(torch.Generator().manual_seed(2), cfg,
                                                    device="cpu")}
    lora = LO.add_lora(base, 3, rank=8, alpha=16.0)
    gen = torch.Generator().manual_seed(4)
    for lp in lora["layers"]:
        for name in LO.DEFAULT_TARGETS:
            b_ = lp["attn"][name]["lora_b"]
            lp["attn"][name]["lora_b"] = torch.randn(b_.shape, generator=gen) * 0.02

    shapes = []
    check_fwd = FA._check_fwd

    def recorded(q, k, v, kv_valid):
        shapes.append((q.shape[2], k.shape[2]))
        return check_fwd(q, k, v, kv_valid)

    def loss_and_grad(tree, batch, device, dtype):
        params = _to(tree, device=device, dtype=dtype)
        TS.init_train_state(params, TS.make_optimizer())
        tb = {k: torch.as_tensor(np.asarray(v), device=device) for k, v in batch.items()}
        loss, _ = TS.loss_fn(params, cfg, tb, 0, 0.025, remat=True)
        named = list(TS.named_leaves(params))
        grads = torch.autograd.grad(loss, [t for _, t in named], allow_unused=True)
        flat = [(n, (torch.zeros_like(t) if g is None else g).float().flatten().cpu())
                for (n, t), g in zip(named, grads)]
        check(bool(torch.isfinite(loss)) and all(bool(torch.isfinite(g).all())
                                                 for _, g in flat),
              f"small vision/PEFT training {device} {dtype}: non-finite loss or gradient")
        return loss.item(), flat

    lines = []
    for label, tree, batch in (("image batch", base, img), ("prefix tuning", prefix, text),
                               ("LoRA", lora, text)):
        ref_loss, ref = loss_and_grad(tree, batch, "cpu", torch.float32)
        before = (FA.flash_attention.launches, FA.flash_attention_bwd_dq.launches,
                  FA.flash_attention_bwd_dkv.launches)
        shapes.clear()
        FA._check_fwd = recorded
        try:
            loss, got = loss_and_grad(tree, batch, "cuda", torch.bfloat16)
        finally:
            FA._check_fwd = check_fwd
        after = (FA.flash_attention.launches, FA.flash_attention_bwd_dq.launches,
                 FA.flash_attention_bwd_dkv.launches)
        launched = tuple(a - b for a, b in zip(after, before))
        check(launched == (2 * L, L, L),
              f"small {label} training did not go through the flash kernels: {launched}")
        S = T + (PE.N_VIRTUAL_TOKENS if label == "prefix tuning" else 0)
        check(shapes == [(T, S)] * (2 * L), f"small {label} training: K1 (T, S) {shapes}")
        rel_loss = abs(loss - ref_loss) / abs(ref_loss)
        rel_grad = _rel(torch.cat([g for _, g in got]), torch.cat([g for _, g in ref]))
        check(rel_loss < TRAIN_LOSS_REL and rel_grad < TRAIN_GRAD_REL_L2,
              f"small {label} training, bf16 card vs f32 CPU: loss {rel_loss}, gradient "
              f"{rel_grad} (limits {TRAIN_LOSS_REL}, {TRAIN_GRAD_REL_L2})")
        part = {"image batch": "vision/", "prefix tuning": "peft/", "LoRA": "lora"}[label]
        sub = [i for i, (n, _) in enumerate(ref) if part in n]
        sub_rel = _rel(torch.cat([got[i][1] for i in sub]), torch.cat([ref[i][1] for i in sub]))
        check(all(got[i][1].abs().max() > 0 for i in sub) and sub_rel < TRAIN_GRAD_REL_L2,
              f"small {label} training: the adapter's or tower's gradient, relative L2 "
              f"{sub_rel} (limit {TRAIN_GRAD_REL_L2}), or a zero leaf")
        lines.append(f"{label}: loss {ref_loss:.5f} (f32), relative error {rel_loss:.3e}; "
                     f"gradient relative L2 {rel_grad:.3e}, of its {len(sub)} "
                     f"{part.strip('/')} leaves {sub_rel:.3e}; K1 (T, S) {shapes[0]}")
    print(f"reference check: 2-layer training loss and gradient with the tower and the "
          f"adapters, bf16 card through K1/K2/K3 ({2 * L}, {L}, {L} launches each) vs f32 CPU "
          f"(limits {TRAIN_LOSS_REL}, {TRAIN_GRAD_REL_L2}): " + "; ".join(lines), flush=True)


def _launch_counts():
    from unimoe_audio_torch.ops import flash_attention as FA
    from unimoe_audio_torch.ops import grouped_gemm as GG

    return {"flash_attention_fwd": FA.flash_attention.launches,
            "flash_attention_bwd_dq": FA.flash_attention_bwd_dq.launches,
            "flash_attention_bwd_dkv": FA.flash_attention_bwd_dkv.launches,
            "flash_attention_bwd_dkv_reduce": FA.flash_attention_bwd_dkv.reduce_launches,
            "flash_attention_fwd_f32": FA.flash_attention.f32_launches,
            "flash_attention_bwd_dq_f32": FA.flash_attention_bwd_dq.f32_launches,
            "flash_attention_bwd_dkv_f32": FA.flash_attention_bwd_dkv.f32_launches,
            "flash_attention_bwd_dkv_f32_reduce": FA.flash_attention_bwd_dkv.f32_reduce_launches,
            "grouped_gemm_gmm": GG.gmm.launches,
            **{f"grouped_gemm_gmm_{c}": n for c, n in GG.gmm.launches_by_config.items()},
            "grouped_gemm_gmm_transposed": GG.gmm.transposed_launches,
            "grouped_gemm_tgmm": GG.tgmm.launches,
            "grouped_gemm_tgmm_reduce": GG.tgmm.reduce_launches}


def _set_launch_counts(counts: dict) -> None:
    from unimoe_audio_torch.ops import flash_attention as FA
    from unimoe_audio_torch.ops import grouped_gemm as GG

    FA.flash_attention.launches = counts["flash_attention_fwd"]
    FA.flash_attention_bwd_dq.launches = counts["flash_attention_bwd_dq"]
    FA.flash_attention_bwd_dkv.launches = counts["flash_attention_bwd_dkv"]
    FA.flash_attention_bwd_dkv.reduce_launches = counts["flash_attention_bwd_dkv_reduce"]
    FA.flash_attention.f32_launches = counts["flash_attention_fwd_f32"]
    FA.flash_attention_bwd_dq.f32_launches = counts["flash_attention_bwd_dq_f32"]
    FA.flash_attention_bwd_dkv.f32_launches = counts["flash_attention_bwd_dkv_f32"]
    FA.flash_attention_bwd_dkv.f32_reduce_launches = counts["flash_attention_bwd_dkv_f32_reduce"]
    GG.gmm.launches = GG.grouped_matmul.launches = counts["grouped_gemm_gmm"]
    for c in GG.GMM_CONFIGS:
        GG.gmm.launches_by_config[c] = counts[f"grouped_gemm_gmm_{c}"]
    GG.gmm.transposed_launches = counts["grouped_gemm_gmm_transposed"]
    GG.tgmm.launches = counts["grouped_gemm_tgmm"]
    GG.tgmm.reduce_launches = counts["grouped_gemm_tgmm_reduce"]


def _zero_launch_counts() -> None:
    _set_launch_counts(dict.fromkeys(_launch_counts(), 0))


def probe_batch(cfg, seed: int = 0, B: int = TRAIN_B, T: int = TRAIN_T) -> dict:
    """The JAX package's train probe batch (`bench.py:85-128`): B TRAIN_B x
    T TRAIN_T codec placeholders, codec ids from seed 0 and the same ids as
    labels (another seed or shape where given)."""
    C = cfg.codec_channels
    codec = np.random.default_rng(seed).integers(0, cfg.codec_eos_value, size=(B, T, C))
    return {"input_ids": np.full((B, T), cfg.codec_placeholder_value, np.int32),
            "codec_input_ids": codec.astype(np.int32),
            "attention_mask": np.ones((B, T), np.int32),
            "codec_labels": codec.astype(np.int32)}


def run_train_slice(card: str, dispatch_mode: str = "dense", dense_losses=None):
    """The training path through the user's entry point, `Trainer.fit`, at
    the flagship width with TRAIN_LAYERS layers, bf16, random weights from
    seed 0, on the batch of the JAX package's train probe (all codec
    placeholders, codec labels = codec ids), remat on, AdamW lr 1e-4 with one
    warm-up step of the schedule, with `dispatch_mode` in the DCMoE blocks
    (gmm: its step 0 loss is held against the dense run's `dense_losses`).
    Returns the launch counts of the run and its losses."""
    import dataclasses

    import torch
    from unimoe_audio_torch.config import TextMoEConfig, UniMoEAudioConfig
    from unimoe_audio_torch.models.model import init_model_params
    from unimoe_audio_torch.ops import grouped_gemm as GG
    from unimoe_audio_torch.train.trainer import Trainer, TrainerConfig

    cfg = UniMoEAudioConfig(
        text_config=dataclasses.replace(TextMoEConfig(), num_hidden_layers=TRAIN_LAYERS),
        vision_config=None)
    params = init_model_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    n_params = sum(t.numel() for t in _leaves(params))
    B, T = TRAIN_B, TRAIN_T
    batch = probe_batch(cfg)
    trainer = Trainer(cfg, params, TrainerConfig(learning_rate=1e-4, warmup_steps=1,
                                                 total_steps=100, log_every=1, remat=True,
                                                 dispatch_mode=dispatch_mode))
    n_steps = 1 + TRAIN_TIMED_STEPS
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    history, _, marks = _fit_marked(trainer, batch, n_steps)   # (time, launch counts)
    launches = _launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    L = TRAIN_LAYERS
    per_step = [{k: b[1][k] - a[1][k] for k in a[1]} for a, b in zip(marks, marks[1:])]
    gmm = dispatch_mode == "gmm"
    rows = B * T * cfg.text_config.mlp_dynamic_expert_num     # A: every slot has a row
    want = {"flash_attention_fwd": 2 * L, "flash_attention_bwd_dq": L,
            "flash_attention_bwd_dkv": L,
            # the GQA sum of the per-head dk, dv (16 query heads, 2 kv heads)
            "flash_attention_bwd_dkv_reduce": L,
            # 3 projections per layer, in the forward and the remat recompute
            "grouped_gemm_gmm": 6 * L if gmm else 0,
            **{f"grouped_gemm_gmm_{c}": 6 * L if gmm and GG.gmm_config(rows) == c else 0
               for c in GG.GMM_CONFIGS},
            "grouped_gemm_gmm_transposed": 3 * L if gmm else 0,
            "grouped_gemm_tgmm": 3 * L if gmm else 0,
            "grouped_gemm_tgmm_reduce":
                3 * L if gmm and GG.tgmm_workspace_slots(rows, 8) else 0,
            # bf16: no f32 kernel
            **{k: 0 for k in per_step[0] if k.endswith(("_f32", "_f32_reduce"))}}
    check(all(p == want for p in per_step), f"launches per step {per_step}, want {want}")
    losses = [h["loss"] for h in history]
    check(len(losses) == n_steps and all(np.isfinite(losses)), f"losses {losses}")
    check(not any(h["skipped"] for h in history), "a training step was skipped")
    check(losses[-1] < losses[1], f"loss did not fall: {losses}")
    if dense_losses is not None:
        rel0 = abs(losses[0] - dense_losses[0]) / abs(dense_losses[0])
        check(rel0 < TRAIN_GMM_LOSS_REL, f"{dispatch_mode} step 0 loss {losses[0]} vs dense "
              f"{dense_losses[0]}: relative {rel0} (limit {TRAIN_GMM_LOSS_REL})")
        print(f"train slice [{card}]: {dispatch_mode} step 0 loss vs dense: relative {rel0:.3e} "
              f"(limit {TRAIN_GMM_LOSS_REL})", flush=True)
    step_s = _durations(marks)[1:]
    med = float(np.median(step_s))
    print(f"train slice [{card}] {dispatch_mode}: {L} layers at flagship width, "
          f"{n_params / 1e9:.3f} B params "
          f"bf16, B {B} x T {T}, remat on; losses {[round(x, 4) for x in losses]}; "
          f"grad norms {[round(h['grad_norm'], 3) for h in history]}", flush=True)
    print(f"train slice [{card}] {dispatch_mode}: step times (s) "
          f"{[round(x, 4) for x in step_s]}, median {med:.4f} s, {B * T / med:.1f} tokens/s; peak memory allocated {peak_gb:.2f} GB; "
          f"launches per step {per_step[0]}; warm-up step {marks[1][0] - marks[0][0]:.2f} s",
          flush=True)
    profile_train_step(trainer, batch, med, card)
    del trainer, params
    return launches, losses


def profile_train_step(trainer, batch, step_s: float, card: str) -> None:
    """One more training step under torch.profiler (after the counted run):
    device kernel time against the step's host wall time, and device time
    by kind of kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.fit([batch])
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if dev_ms == 0:
        print("train profile: torch.profiler recorded no device time: not measured", flush=True)
        return
    kinds = {}
    for e in kernels:
        key = e.key.lower()
        kind = ("flash (K1/K2/K3)" if "flash" in key else
                "grouped gemm (K4/K4t/K5)" if "gmm" in key else
                "gemm" if any(w in key for w in ("gemm", "nvjet", "cutlass", "sm90_xmma")) else
                "elementwise / reduce / copy")
        kinds[kind] = kinds.get(kind, 0.0) + e.self_device_time_total / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    print(f"train profile [{card}]: one step, {wall_ms:.1f} ms host wall under the profiler "
          f"(unprofiled median {step_s * 1e3:.1f} ms), device kernel time {dev_ms:.1f} ms = "
          f"{100 * dev_ms / wall_ms:.1f} % busy; {sum(e.count for e in kernels)} kernel launches; "
          + "; ".join(f"{k} {v:.1f} ms" for k, v in sorted(kinds.items(), key=lambda kv: -kv[1])),
          flush=True)
    for e in top:
        print(f"train profile:   {e.self_device_time_total / 1e3:9.2f} ms  {e.count:6d}x  "
              f"{e.key[:90]}", flush=True)
    # The port's kernels in this step: device time per launch.
    ours = [e for e in kernels if any(w in e.key for w in ("flash_", "gmm_wgmma", "tgmm_reduce"))]
    print(f"train profile [{card}]: the port's kernels, device ms per launch (launches): " + "; ".join(
        f"{e.key.replace('void ', '').replace('(anonymous namespace)::', '').split('(')[0]} "
        f"{e.self_device_time_total / 1e3 / e.count:.4f} ({e.count})"
        for e in sorted(ours, key=lambda e: e.key)), flush=True)



def _fit_marked(trainer, batch, n: int, **kw):
    """trainer.fit over n copies of batch; returns (history, the host time
    before fit, (time, launch counts) as each batch was taken and at the
    end, each after a synchronise)."""
    return _fit_marked_iter(trainer, (batch for _ in range(n)), **kw)


def _fit_marked_iter(trainer, source, **kw):
    """_fit_marked over the batches of an iterable."""
    import torch

    marks = []

    def mark():
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), _launch_counts()))

    def batches():
        for batch in source:
            mark()
            yield batch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    history = trainer.fit(batches(), **kw)
    mark()
    return history, t0, marks


def _durations(marks) -> list:
    return [b[0] - a[0] for a, b in zip(marks, marks[1:])]


def _param_leaves(trainer):
    from unimoe_audio_torch.train.step import named_leaves

    return [t.detach() for _, t in named_leaves(trainer.state.params)]


def _leaf_diff(a, b):
    """(max |a - b|, elements that differ, ||a - b||) over aligned lists of
    tensors."""
    import torch

    mx, n, sq = 0.0, 0, 0.0
    for x, y in zip(a, b):
        d = (x.float() - y.float()).abs()
        mx = max(mx, d.max().item())
        n += int((x != y).sum())
        sq += float(torch.linalg.vector_norm(d)) ** 2
    return mx, n, sq ** 0.5


def _by_name(params) -> list:
    """The leaves of a param tree sorted by name (each layer's in layer
    order), whatever the order of the dict's keys."""
    from unimoe_audio_torch.train.step import named_leaves

    return [t for _, t in sorted(named_leaves(params), key=lambda x: x[0])]


def _per_step(launches: dict, steps: int) -> dict:
    return {k: v // steps for k, v in launches.items() if v}


def run_train_core(card: str) -> dict:
    """The training core through `Trainer` at the flagship width cut to
    TRAIN_CORE_LAYERS layers, on the train probe's batch (TRAIN_CORE_*
    above): resume against an uninterrupted run (bf16), gradient
    accumulation against one step (f32, the f32 kernels), the Gumbel mixer
    (bf16) beside the closed-form one, and the export loaded by the port's
    UniMoEAudio.  Returns the launch counts of its paths (train_resume: the
    first uninterrupted run; train_accum_f32: the accumulating trainer;
    train_mixer)."""
    import dataclasses

    import torch
    from unimoe_audio_torch.api import UniMoEAudio
    from unimoe_audio_torch.config import TextMoEConfig, UniMoEAudioConfig
    from unimoe_audio_torch.models.model import init_model_params, model_forward
    from unimoe_audio_torch.train.trainer import Trainer, TrainerConfig

    L, k = TRAIN_CORE_LAYERS, TRAIN_CORE_K
    tc = dataclasses.replace(TextMoEConfig(), num_hidden_layers=L)
    cfg = UniMoEAudioConfig(text_config=tc, vision_config=None)
    batch = probe_batch(cfg)
    tkw = dict(learning_rate=1e-4, warmup_steps=1, total_steps=100, log_every=1, remat=True)
    bf16 = torch.bfloat16
    paths = {}
    per_step_bf16 = {"flash_attention_fwd": 2 * L, "flash_attention_bwd_dq": L,
                     "flash_attention_bwd_dkv": L, "flash_attention_bwd_dkv_reduce": L}

    def trainer(c, seed, dtype, **extra):
        return Trainer(c, init_model_params(c, seed=seed, dtype=dtype, device="cuda"),
                       TrainerConfig(**{**tkw, **extra}))

    # Resume, bf16: two uninterrupted runs of 2k steps (the floor), then k
    # steps, a save, a fresh Trainer (other initial weights) that resumes,
    # k more steps.
    runs = []
    for rep in range(2):
        tr = trainer(cfg, 0, bf16)
        _zero_launch_counts()
        hist, _, marks = _fit_marked(tr, batch, 2 * k)
        if rep == 0:
            paths["train_resume"] = _launch_counts()
            check(_per_step(paths["train_resume"], 2 * k) == per_step_bf16,
                  f"train core: launches {paths['train_resume']} over {2 * k} steps, want "
                  f"{per_step_bf16} a step")
        runs.append(([h["loss"] for h in hist], [t.clone() for t in _param_leaves(tr)],
                     _durations(marks)))
        del tr
    torch.cuda.empty_cache()
    (losses, ref, closed_step_s), (losses2, ref2, _) = runs
    check(all(np.isfinite(losses)), f"train core: losses {losses}")
    floor = _leaf_diff(ref2, ref)
    deterministic = losses2 == losses and floor[1] == 0
    with tempfile.TemporaryDirectory() as ck:
        first = trainer(cfg, 0, bf16)
        _fit_marked(first, batch, k)
        first.tcfg = dataclasses.replace(first.tcfg, ckpt_dir=ck, max_to_keep=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first.save()
        save_s = time.perf_counter() - t0
        ck_bytes = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(ck)
                       for f in fs)
        del first
        torch.cuda.empty_cache()
        second = trainer(cfg, 1, bf16, ckpt_dir=ck, max_to_keep=1)
        hist2, t0, marks = _fit_marked(second, batch, k, max_steps=2 * k)
        restore_s = marks[0][0] - t0
    check([h["step"] for h in hist2] == list(range(k, 2 * k)),
          f"train core: resumed steps {[h['step'] for h in hist2]}")
    resumed = losses[:k] + [h["loss"] for h in hist2]
    got = _leaf_diff(_param_leaves(second), ref)
    if deterministic:
        check(resumed == losses and got[1] == 0,
              f"train core: resumed run differs from the uninterrupted one (deterministic "
              f"path): losses {resumed} vs {losses}, {got[1]} elements, max {got[0]}")
    else:
        check(got[0] <= TRAIN_RESUME_VS_FLOOR * floor[0],
              f"train core: resumed run max |diff| {got[0]} vs the floor {floor[0]}")
    n_params = sum(t.numel() for t in ref)
    print(f"train core [{card}]: resume, bf16, {L} layers at flagship width ({n_params / 1e9:.3f}"
          f" B params), B {TRAIN_B} x T {TRAIN_T}: {k} steps, save, a new Trainer resumes, {k} "
          f"more, against {2 * k} straight: losses {[round(x, 6) for x in resumed]} vs "
          f"{[round(x, 6) for x in losses]}; parameters: {got[1]} elements differ (max "
          f"{got[0]:.3e}); two straight runs differ in {floor[1]} elements (max "
          f"{floor[0]:.3e}){' (bit-equal: deterministic path)' if deterministic else ''}; "
          f"checkpoint {ck_bytes / 1e9:.3f} GB (parameters, moments), save {save_s:.2f} s, "
          f"restore {restore_s:.2f} s (the fit's start to its first step)", flush=True)

    # The export of the resumed trainer, loaded by the port's UniMoEAudio.
    with tempfile.TemporaryDirectory() as ex:
        t0 = time.perf_counter()
        second.save_pretrained(ex)
        export_s = time.perf_counter() - t0
        ex_bytes = os.path.getsize(os.path.join(ex, "model.jax.pkl"))
        t0 = time.perf_counter()
        model = UniMoEAudio(ex, dtype=bf16, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    cast = _to(second.state.params, dtype=bf16)          # as the loader casts the leaves
    same = _leaf_diff(_by_name(model.params), _by_name(cast))
    check(same[1] == 0, f"export: loaded parameters differ in {same[1]} elements")
    rng = np.random.default_rng(7)
    ids = torch.as_tensor(rng.integers(0, tc.vocab_size - 8, size=(4, 128)), device="cuda")
    mask = torch.ones(4, 128, dtype=torch.int32, device="cuda")
    mask[1, :40] = 0
    counts = _launch_counts()
    with torch.inference_mode():
        a = model_forward(model.params, cfg, ids, attention_mask=mask).codec_logits
        b = model_forward(cast, cfg, ids, attention_mask=mask).codec_logits
    check(_launch_counts()["flash_attention_fwd"] == counts["flash_attention_fwd"] + 2 * L,
          "export: the prefills did not take K1")
    _set_launch_counts(counts)
    check(bool(torch.isfinite(a).all()) and torch.equal(a, b),
          f"export: prefill codec logits differ, max {(a.float() - b.float()).abs().max().item()}")
    print(f"train core [{card}]: export: save_pretrained {ex_bytes / 1e9:.3f} GB "
          f"(model.jax.pkl, f32 leaves) in {export_s:.2f} s; UniMoEAudio load {load_s:.2f} s; "
          f"prefill codec logits [4, 128] through K1 equal to the trainer's bit for bit",
          flush=True)
    del model, cast, second, ref, ref2
    torch.cuda.empty_cache()

    # Gradient accumulation, f32: one step of the batch against two
    # micro-steps of it (warm-up 0, so the one update moves the parameters).
    acfg = dataclasses.replace(cfg, text_config=dataclasses.replace(
        tc, input_jitter_noise=0.0, min_l_aux_weight=tc.l_aux_weight))
    akw = dict(warmup_steps=0)
    one = trainer(acfg, 0, torch.float32, **akw)
    start = [t.clone() for t in _param_leaves(one)]
    h_one, _, m_one = _fit_marked(one, batch, 1)
    p_one = [t.clone() for t in _param_leaves(one)]
    del one
    torch.cuda.empty_cache()
    two = trainer(acfg, 0, torch.float32, grad_accum_steps=2, **akw)
    _zero_launch_counts()
    h_two, _, m_two = _fit_marked(two, batch, 2)
    paths["train_accum_f32"] = _launch_counts()
    # The f32 dk/dv kernel sums the GQA heads itself: no reduce launch.
    want = {f"{k}_f32": v for k, v in per_step_bf16.items() if not k.endswith("reduce")}
    check(_per_step(paths["train_accum_f32"], 2) == want,
          f"train core: f32 launches {paths['train_accum_f32']} over 2 micro-steps, want {want} "
          f"a micro-step")
    st = two.state
    check(st.step == 2 and st.opt_state.count == 1 and st.opt_state.mini_step == 0,
          f"accumulation: step {st.step}, updates {st.opt_state.count}, mini-step "
          f"{st.opt_state.mini_step}")
    diff = _leaf_diff(_param_leaves(two), p_one)
    update = _leaf_diff(p_one, start)
    rel = diff[2] / max(update[2], 1e-30)
    l_one, l_two = h_one[0]["loss"], [h["loss"] for h in h_two]
    check(all(np.isfinite(l_two)) and update[1] > 0 and rel <= TRAIN_ACCUM_REL,
          f"accumulation: parameters differ by {rel:.3e} of the update (limit "
          f"{TRAIN_ACCUM_REL}); losses {l_two} vs {l_one}")
    print(f"train core [{card}]: gradient accumulation, f32, {L} layers, input jitter off, a "
          f"constant aux-loss weight: two "
          f"micro-steps of the batch (grad_accum_steps 2) vs one step: losses {l_two} vs "
          f"{l_one}; parameters: {diff[1]} elements differ (max {diff[0]:.3e}), relative L2 "
          f"{rel:.3e} of the update (limit {TRAIN_ACCUM_REL}; the update moved {update[1]} "
          f"elements); micro-step times (s) {[round(x, 4) for x in _durations(m_two)]}, one "
          f"step {_durations(m_one)[0]:.4f} s; f32 launches per micro-step "
          f"{_per_step(paths['train_accum_f32'], 2)}", flush=True)
    del two, start, p_one
    torch.cuda.empty_cache()

    # The Gumbel / straight-through mixer, bf16.
    mcfg = dataclasses.replace(cfg, text_config=dataclasses.replace(
        tc, ignore_differentiable_router=False))
    tr = trainer(mcfg, 0, bf16)
    _zero_launch_counts()
    hist, _, marks = _fit_marked(tr, batch, TRAIN_MIXER_STEPS)
    paths["train_mixer"] = _launch_counts()
    check(_per_step(paths["train_mixer"], TRAIN_MIXER_STEPS) == per_step_bf16,
          f"train core: mixer launches {paths['train_mixer']}")
    m_losses = [h["loss"] for h in hist]
    check(all(np.isfinite(m_losses)) and not any(h["skipped"] for h in hist),
          f"mixer: losses {m_losses}, skipped {[h['skipped'] for h in hist]}")
    mixer_s = _durations(marks)
    print(f"train core [{card}]: Gumbel / straight-through mixer (ignore_differentiable_router"
          f"=False), bf16, {L} layers: losses {[round(x, 5) for x in m_losses]}, mean top-k "
          f"{[round(h['mean_top_k'], 3) for h in hist]}; step times (s) "
          f"{[round(x, 4) for x in mixer_s]} against the closed-form mixer's "
          f"{[round(x, 4) for x in closed_step_s]} (the resume check's first run)", flush=True)
    del tr
    torch.cuda.empty_cache()
    return paths

def _moved(a, b) -> bool:
    """Whether a tensor of list a differs from its partner in list b."""
    import torch

    return any(not torch.equal(x, y) for x, y in zip(a, b))


def run_train_vision(card: str) -> dict:
    """Vision training through `Trainer.fit` (TRAIN_VISION_* above): the
    flagship width cut to TRAIN_VISION_LAYERS decoder layers with the full
    32-block tower, bf16, remat on.  The batch comes only through the
    port's data path: two image samples (`expand_image_tokens`,
    `preprocess_supervised`, patches from `apps/video.video_to_patches` on
    seeded numpy images), two text-only samples from a `ConversationDataset`
    over a list of dicts, `Collator(aux_balance_weight=10)` and `prefetch`.
    One warm-up and TRAIN_VISION_STEPS timed steps with train_vision (the
    tower in the step, K1/K2/K3 in the decoder): finite losses, the tower's
    patch embed moved.  Then one step with trainable_pattern
    r"^(?!vision)" (the tower bit-unchanged, embed_tokens moved) and one
    with train_vision=False (the tower bit-unchanged, the decoder moved).
    Returns the launch counts of the timed run."""
    import dataclasses

    import torch
    from unimoe_audio_torch.apps.video import video_to_patches
    from unimoe_audio_torch.config import TextMoEConfig, UniMoEAudioConfig
    from unimoe_audio_torch.models.model import init_model_params
    from unimoe_audio_torch.train import data as D
    from unimoe_audio_torch.train.step import named_leaves
    from unimoe_audio_torch.train.trainer import Trainer, TrainerConfig

    L = TRAIN_VISION_LAYERS
    cfg = UniMoEAudioConfig(text_config=dataclasses.replace(TextMoEConfig(),
                                                             num_hidden_layers=L))
    vcfg = cfg.vision_config
    tok = D.SimpleTokenizer(vocab_size=cfg.text_config.vocab_size, special={
        "<|vision_start|>": cfg.vision_start_token_id, "<|vision_end|>": cfg.vision_end_token_id,
        "<|image_pad|>": cfg.image_token_id})
    rng = np.random.default_rng(5)
    m2 = vcfg.spatial_merge_size ** 2
    samples, grids = [], []
    for i in range(2):
        image = rng.uniform(0, 255, size=(1, 3, TRAIN_VISION_IMAGE, TRAIN_VISION_IMAGE))
        patches, grid = video_to_patches(image.astype(np.float32), patch_size=vcfg.patch_size,
                                         temporal_patch_size=vcfg.temporal_patch_size,
                                         merge_size=vcfg.spatial_merge_size)
        conv = D.expand_image_tokens([{"from": "human", "value": caption(12 + 4 * i)},
                                      {"from": "gpt", "value": caption(20 + 4 * i)}],
                                     int(grid.prod()) // m2)
        sample = D.preprocess_supervised(conv, tok, image_token_index=cfg.image_token_id,
                                         has_image=True, model_max_length=4096)
        sample.update(pixel_values=patches, image_grid_thw=grid[None])
        samples.append(sample)
        grids.append(grid.tolist())
    rows = [{"conversations": [{"from": "human", "value": caption(30 + 6 * i)},
                               {"from": "gpt", "value": caption(40 + 6 * i)}]} for i in range(2)]
    dataset = D.ConversationDataset(rows, tok, image_token_index=cfg.image_token_id,
                                    vision_config=vcfg)
    samples += [dataset[0], dataset[1]]
    collator = D.Collator(pad_token_id=tok.pad_token_id, aux_balance_weight=10.0)
    n_steps = 1 + TRAIN_VISION_STEPS
    batch = collator(samples)
    B, T = batch["input_ids"].shape
    n_img = int((batch["input_ids"] == cfg.image_token_id).sum())
    check(grids == [[1, 32, 32]] * 2 and n_img == 512,
          f"vision training batch: grids {grids}, {n_img} image tokens")

    params = init_model_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda", with_vision=True)
    n_params = sum(t.numel() for _, t in named_leaves(params))
    n_tower = sum(t.numel() for _, t in named_leaves(params["vision"]))
    pe0 = params["vision"]["patch_embed"].clone()
    tkw = dict(learning_rate=1e-4, total_steps=100, log_every=1, remat=True)
    trainer = Trainer(cfg, params, TrainerConfig(warmup_steps=1, **tkw))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    history, _, marks = _fit_marked_iter(
        trainer, D.prefetch(collator(samples) for _ in range(n_steps)))
    launches = _launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    per_step = [{k: b[1][k] - a[1][k] for k in a[1] if b[1][k] - a[1][k]}
                for a, b in zip(marks, marks[1:])]
    want = {"flash_attention_fwd": 2 * L, "flash_attention_bwd_dq": L,
            "flash_attention_bwd_dkv": L, "flash_attention_bwd_dkv_reduce": L}
    check(all(p == want for p in per_step), f"vision training launches per step {per_step}, "
          f"want {want}")
    losses = [h["loss"] for h in history]
    check(len(losses) == n_steps and all(np.isfinite(losses))
          and not any(h["skipped"] for h in history), f"vision training losses {losses}")
    check(not torch.equal(params["vision"]["patch_embed"], pe0),
          "vision training: the tower's patch embed did not move")
    step_s = _durations(marks)[1:]
    med = float(np.median(step_s))
    print(f"train vision [{card}]: {L} decoder layers at flagship width with the 32-block "
          f"tower, {n_params / 1e9:.3f} B params ({n_tower / 1e9:.3f} B in the tower), bf16, "
          f"remat on; B {B} x T {T} (2 images of grid 1x32x32, {n_img} image tokens, 2 text "
          f"samples; ConversationDataset, Collator, prefetch); losses "
          f"{[round(x, 4) for x in losses]}; step times (s) {[round(x, 4) for x in step_s]}, "
          f"median {med:.4f} s; warm-up step {marks[1][0] - marks[0][0]:.2f} s; peak memory "
          f"allocated {peak_gb:.2f} GB; launches per step {per_step[0]}", flush=True)
    del trainer
    torch.cuda.empty_cache()

    def one_step(**extra):
        tower = [t.clone() for _, t in named_leaves(params["vision"])]
        emb, q = params["embed_tokens"].clone(), params["layers"][0]["attn"]["q_proj"]["w"].clone()
        tr = Trainer(cfg, params, TrainerConfig(warmup_steps=0, **tkw, **extra))
        hist = tr.fit([collator(samples)])
        check(np.isfinite(hist[0]["loss"]), f"vision training {extra}: loss {hist[0]['loss']}")
        still = not _moved([t for _, t in named_leaves(params["vision"])], tower)
        moved = (not torch.equal(params["embed_tokens"], emb),
                 not torch.equal(params["layers"][0]["attn"]["q_proj"]["w"], q))
        del tr
        torch.cuda.empty_cache()
        return still, moved

    still, (emb_moved, _) = one_step(trainable_pattern=r"^(?!vision)")
    check(still and emb_moved, f"vision training, pattern ^(?!vision): tower unchanged {still}, "
          f"embed_tokens moved {emb_moved}")
    still_f, (_, q_moved) = one_step(train_vision=False)
    check(still_f and q_moved, f"vision training, train_vision=False: tower unchanged {still_f},"
          f" decoder moved {q_moved}")
    print(f"train vision [{card}]: one step with trainable_pattern ^(?!vision): the tower "
          f"bit-unchanged, embed_tokens moved; one step with train_vision=False (the tower's "
          f"features fused outside the step): the tower bit-unchanged, the decoder moved",
          flush=True)
    del params
    torch.cuda.empty_cache()
    return launches


def run_peft(card: str) -> dict:
    """PEFT, surgery and resharding at the flagship width (PEFT_* above):
    one LoRA step (trainable "lora": only LoRA leaves move, the base stays
    bit-unchanged), one prefix-tuning step (every K1 over S = T + 10 keys)
    and one P-tuning step (T + 10 queries), trainable "peft", bf16 on the
    train probe's batch; the LoRA merged into the base and a short greedy
    text_to_music on it; the f32 witness, card vs CPU, with the prefix in
    the cache and with P-tuning's soft prompts; surgery of a dense model and
    one step of the result; expert shards split and merged.  Returns the
    launch counts of the three adapter steps."""
    import copy
    import dataclasses

    import torch
    from unimoe_audio_torch.api import UniMoEAudio
    from unimoe_audio_torch.config import TextMoEConfig, UniMoEAudioConfig
    from unimoe_audio_torch.models.model import init_model_params
    from unimoe_audio_torch.ops import flash_attention as FA
    from unimoe_audio_torch.train import peft as PE
    from unimoe_audio_torch.train.lora import add_lora, merge_lora
    from unimoe_audio_torch.train.resharding import merge_expert_shards, split_expert_shards
    from unimoe_audio_torch.train.step import named_leaves
    from unimoe_audio_torch.train.surgery import moeify_dense_params
    from unimoe_audio_torch.train.trainer import Trainer, TrainerConfig

    L = PEFT_LAYERS
    tc = dataclasses.replace(TextMoEConfig(), num_hidden_layers=L)
    cfg = UniMoEAudioConfig(text_config=tc, vision_config=None)
    batch = probe_batch(cfg)
    n_virtual = PE.N_VIRTUAL_TOKENS
    tkw = dict(learning_rate=1e-4, warmup_steps=0, total_steps=100, log_every=1, remat=True)
    per_step = {"flash_attention_fwd": 2 * L, "flash_attention_bwd_dq": L,
                "flash_attention_bwd_dkv": L, "flash_attention_bwd_dkv_reduce": L}
    base = init_model_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    base_names = [n for n, _ in named_leaves(base)]
    frozen = [t.clone() for _, t in named_leaves(base)]
    shapes = []
    check_fwd = FA._check_fwd

    def recorded(q, k, v, kv_valid):
        shapes.append((q.shape[2], k.shape[2]))
        return check_fwd(q, k, v, kv_valid)

    def adapter_step(params, pattern, label):
        before = [t.clone() for n, t in named_leaves(params) if pattern in n]
        tr = Trainer(cfg, params, TrainerConfig(trainable_pattern=pattern, **tkw))
        counts = _launch_counts()
        shapes.clear()
        FA._check_fwd = recorded
        try:
            hist, _, marks = _fit_marked(tr, batch, 1)
        finally:
            FA._check_fwd = check_fwd
        got = {k: v - counts[k] for k, v in _launch_counts().items() if v - counts[k]}
        check(got == per_step, f"{label}: launches {got}, want {per_step}")
        check(np.isfinite(hist[0]["loss"]) and not hist[0]["skipped"],
              f"{label}: loss {hist[0]['loss']}")
        check(not _moved([t for n, t in named_leaves(params) if n in base_names], frozen),
              f"{label}: a base parameter moved under trainable_pattern {pattern!r}")
        after = [t for n, t in named_leaves(params) if pattern in n]
        n_moved = sum(not torch.equal(a, b) for a, b in zip(after, before))
        check(n_moved > 0, f"{label}: no adapter leaf moved")
        del tr
        torch.cuda.empty_cache()
        return hist[0]["loss"], _durations(marks)[0], n_moved, len(before), list(shapes)

    _zero_launch_counts()
    lora = add_lora(base, 1, rank=PEFT_LORA_RANK, alpha=PEFT_LORA_ALPHA)
    gen = torch.Generator(device="cuda").manual_seed(2)
    prefix = {**base, "peft": PE.init_prefix_tuning(gen, cfg, device="cuda")}
    ptuning = {**base, "peft": PE.init_p_tuning(gen, cfg, device="cuda")}
    results = {label: adapter_step(p, pattern, label) for label, p, pattern in (
        ("LoRA", lora, "lora"), ("prefix tuning", prefix, "peft"), ("P-tuning", ptuning, "peft"))}
    launches = _launch_counts()
    T = TRAIN_T
    check(results["prefix tuning"][4] == [(T, T + n_virtual)] * (2 * L)
          and results["P-tuning"][4] == [(T + n_virtual, T + n_virtual)] * (2 * L)
          and results["LoRA"][4] == [(T, T)] * (2 * L),
          f"PEFT: K1 (T, S) {[r[4] for r in results.values()]}")
    print(f"train peft [{card}]: {L} layers at flagship width, bf16, B {TRAIN_B} x T {T}, remat "
          f"on, one step each (trainable lora / peft; the base bit-unchanged): " + "; ".join(
              f"{k}: loss {r[0]:.5f}, step {r[1]:.4f} s, {r[2]} of {r[3]} adapter leaves moved, "
              f"K1 (T, S) {r[4][0]}" for k, r in results.items())
          + f"; launches per step {per_step}", flush=True)
    del prefix, ptuning
    torch.cuda.empty_cache()

    # The merged LoRA model serves.
    with tempfile.TemporaryDirectory() as out_dir:
        model = UniMoEAudio(allow_random=True, config=cfg, device="cuda", dtype=torch.bfloat16)
        model.params = merge_lora(lora)
        check(all("lora_a" not in lp["attn"]["q_proj"] for lp in model.params["layers"]),
              "merge_lora left a factor")
        t0 = time.perf_counter()
        paths = model.text_to_music(caption(58), output_dir=out_dir, seed=0, do_sample=False,
                                    max_audio_seconds=1.0, min_audio_seconds=0.5)
        merged_s = time.perf_counter() - t0
        frames = model.last_timings["lengths"][0]
        _check_wavs(paths, [frames], model.dac.config.hop_length, model.dac.config.sample_rate,
                    "merged LoRA text_to_music")
    print(f"train peft [{card}]: merge_lora, then greedy text_to_music on the merged model "
          f"(bf16, T_text {model.last_timings['T_text']}): {frames} frames in {merged_s:.2f} s",
          flush=True)
    del lora, base, frozen
    torch.cuda.empty_cache()

    # The f32 witness, card vs CPU.
    f32 = init_model_params(cfg, seed=3, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(4)
    adapters = {"prefix": PE.init_prefix_tuning(gen, cfg, device="cuda"),
                "ptuning": PE.init_p_tuning(gen, cfg, device="cuda")}
    text = caption(58)
    # PEFT_WITNESS_FRAMES audio frames: the budget's last max_delay + 1 frames
    # flush the delay pattern (half a frame keeps int(seconds * 50) exact).
    seconds = (PEFT_WITNESS_FRAMES + cfg.max_delay + 1.5) / 50
    lines = []
    for mode, peft in adapters.items():
        runs, tapes = [], []
        for device in ("cuda", "cpu"):
            ref = copy.copy(model)
            ref.device, ref.dac = torch.device(device), None
            ref.params = {**f32, "peft": peft} if device == "cuda" else \
                _to({**f32, "peft": peft}, device="cpu")
            tape: list = []
            with tempfile.TemporaryDirectory() as out_dir, first_decode_logits() as logits, \
                    router_tape(tape, tapes[0] if tapes else None):
                ref.text_to_music(text, output_dir=out_dir, seed=0, do_sample=False,
                                  max_audio_seconds=seconds, min_audio_seconds=seconds)
            runs.append((ref.last_codes[0], ref.last_timings["T_text"], logits[0]))
            tapes.append(tape)
            del ref
        (card_codes, T_text, card_logits), (cpu_codes, _, cpu_logits) = runs
        err = _rel(card_logits, cpu_logits)
        router_err, flips = replay_report(*tapes, cfg.text_config)
        share = _equal_frame_share([(card_codes, len(card_codes), cpu_codes, len(cpu_codes))], 0)
        check(err < PEFT_REF_REL_L2 and router_err < VT2M_REF_REL_L2
              and share >= SERVE_REF_EQUAL_SHARE
              and len(card_codes) == len(cpu_codes) == PEFT_WITNESS_FRAMES,
              f"PEFT f32 witness ({mode}): first decode logits relative L2 {err}, router logits "
              f"{router_err}, equal frames {share}, frames {len(card_codes)} / {len(cpu_codes)}")
        lines.append(f"{mode}: T_text {T_text}, first decode step's codec logits relative L2 "
                     f"{err:.3e}, router logits {router_err:.3e}, {len(card_codes)} frames, "
                     f"equal {share:.4f}, route_flips {sum(flips)} over {len(flips)} calls")
    print(f"reference check [{card}]: PEFT f32 witness, {L} layers at flagship width, greedy "
          f"text_to_music, card vs CPU under the card's routing (limits {PEFT_REF_REL_L2}, "
          f"router logits {VT2M_REF_REL_L2}, {SERVE_REF_EQUAL_SHARE} equal frames): "
          + "; ".join(lines), flush=True)
    del f32, adapters, model
    torch.cuda.empty_cache()

    # Surgery: a dense flagship-width model into DCMoE experts, one step.
    dense = init_model_params(cfg, seed=5, dtype=torch.bfloat16, device="cuda")
    D, F = tc.hidden_size, tc.intermediate_size
    gen = torch.Generator(device="cuda").manual_seed(6)
    for lp in dense["layers"]:
        del lp["moe"]
        lp["mlp"] = {k: torch.randn(*shape, generator=gen, device="cuda").mul_(
                         shape[0] ** -0.5).to(torch.bfloat16)
                     for k, shape in (("gate", (D, F)), ("up", (D, F)), ("down", (F, D)))}
    t0 = time.perf_counter()
    moe = moeify_dense_params(dense, tc, moe_copy="all")
    torch.cuda.synchronize()
    surgery_s = time.perf_counter() - t0
    Fd, Fs = tc.dynamic_intermediate_size, tc.shared_intermediate_size
    ok = all("mlp" in lp and "moe" not in lp for lp in dense["layers"])
    for lp, mp in zip(dense["layers"], moe["layers"]):
        m = mp["moe"]
        ok &= m["gate"].dtype == torch.float32 and m["gate"].shape == (D, tc.num_experts)
        for e in range(tc.mlp_dynamic_expert_num):
            off = (e * Fd) % F
            ok &= torch.equal(m["dynamic"]["up"][e], lp["mlp"]["up"][:, off:off + Fd])
            ok &= torch.equal(m["dynamic"]["down"][e], lp["mlp"]["down"][off:off + Fd])
        ok &= all(torch.equal(m["fixed"]["gate"][j], lp["mlp"]["gate"][:, :Fs])
                  for j in range(tc.mlp_fixed_expert_num))
    check(bool(ok), "surgery: expert slices, the f32 gate or the untouched input differ")
    del dense
    torch.cuda.empty_cache()
    tr = Trainer(cfg, moe, TrainerConfig(**tkw))
    counts = _launch_counts()
    hist, _, marks = _fit_marked(tr, batch, 1)
    got = {k: v - counts[k] for k, v in _launch_counts().items() if v - counts[k]}
    check(got == per_step and np.isfinite(hist[0]["loss"]),
          f"surgered model's step: launches {got}, loss {hist[0]['loss']}")
    _set_launch_counts(counts)
    del tr
    splits = {}
    for ep in PEFT_EP_SIZES:
        shards = split_expert_shards(moe, ep)
        back = merge_expert_shards(shards)
        splits[ep] = all(torch.equal(b[k], lp["moe"]["dynamic"][k])
                         for b, lp in zip(back, moe["layers"]) for k in b)
        check(len(shards) == ep and splits[ep], f"expert shards at ep {ep} do not round-trip")
    print(f"train peft [{card}]: surgery of a dense {L}-layer flagship-width model (F {F} into "
          f"{tc.mlp_dynamic_expert_num} dynamic experts of {Fd} at rotating offsets, "
          f"{tc.mlp_fixed_expert_num} fixed of {Fs}, a fresh f32 gate) in {surgery_s:.2f} s; "
          f"one step of the result: loss {hist[0]['loss']:.5f}, {_durations(marks)[0]:.4f} s; "
          f"expert shards split and merged bit for bit at ep {list(splits)}", flush=True)
    del moe
    torch.cuda.empty_cache()
    return launches


def _meminfo() -> str:
    """Host memory from /proc/meminfo: MemTotal and MemAvailable."""
    vals = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, rest = line.split(":", 1)
            vals[key] = int(rest.split()[0]) * 1024
    return (f"host MemTotal {vals['MemTotal'] / 1e9:.1f} GB, MemAvailable "
            f"{vals['MemAvailable'] / 1e9:.1f} GB")


def _pcie_rates(nbytes: int = 1 << 30, reps: int = 3) -> str:
    """Host-to-device and device-to-host copy rates of a page-locked
    `HostArena` buffer (the trainers' host memory), CUDA events, the best of
    `reps`."""
    import torch
    from unimoe_audio_torch.train.offload import HostArena

    arena = HostArena([((nbytes,), torch.uint8)], "cuda")
    host, dev = arena.tensors[0], torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    best = {}
    for name, (dst, src) in (("h2d", (dev, host)), ("d2h", (host, dev))):
        for _ in range(reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            dst.copy_(src, non_blocking=True)
            b.record()
            b.synchronize()
            best[name] = max(best.get(name, 0.0), nbytes / (a.elapsed_time(b) / 1e3) / 1e9)
    arena.close()
    del arena, host, dev
    return f"page-locked copies of {nbytes / 1e9:.2f} GB: h2d {best['h2d']:.1f} GB/s, d2h " \
           f"{best['d2h']:.1f} GB/s"


def _snapshot(trainer) -> list:
    """A copy of the stream trainer's whole model on the card, in
    `named_leaves` order."""
    from unimoe_audio_torch.train.step import named_leaves

    return [t for _, t in named_leaves(trainer.full_params("cuda"))]


def _params_close(got, want, names, lr_sum: float) -> tuple:
    """(max |diff| outside the k_proj biases, max |diff| of the k_proj
    biases, whether each is within its limit)."""
    rest = bias = 0.0
    for n, a, b in zip(names, got, want):
        d = (a.float() - b.float()).abs().max().item()
        if n.endswith("k_proj/b"):
            bias = max(bias, d)
        else:
            rest = max(rest, d)
    return rest, bias, rest <= OFFLOAD_PARAM_ATOL and bias <= 2 * lr_sum + OFFLOAD_PARAM_ATOL


def check_small_offload_stream(card: str) -> None:
    """The offload and stream trainers against `Trainer`, each other, the
    CPU and themselves (OFFLOAD_* above)."""
    import dataclasses

    import torch
    from unimoe_audio_torch.config import TextMoEConfig, UniMoEAudioConfig
    from unimoe_audio_torch.models.model import init_model_params
    from unimoe_audio_torch.train.offload import OffloadAdamW, OffloadTrainer
    from unimoe_audio_torch.train.step import make_lr_schedule, named_leaves, train_step
    from unimoe_audio_torch.train.stream import StreamTrainer
    from unimoe_audio_torch.train.trainer import Trainer, TrainerConfig

    L, S, seed = OFFLOAD_SMALL_LAYERS, OFFLOAD_SMALL_STEPS, 7
    tc = dataclasses.replace(TextMoEConfig(), num_hidden_layers=L)
    cfg = UniMoEAudioConfig(text_config=tc, vision_config=None)
    f32 = torch.float32
    lr, wd, total = 1e-4, 0.1, 100
    sched = make_lr_schedule(lr, 0, total)
    lr_sum = sum(sched(c) for c in range(S))
    batches = [probe_batch(cfg, seed=s, B=OFFLOAD_SMALL_B, T=OFFLOAD_SMALL_T)
               for s in range(S + 1)]
    torch.cuda.empty_cache()
    t_start = time.perf_counter()

    def params(c=cfg):
        return init_model_params(c, seed=0, dtype=f32, device="cuda")

    def stream(moment="float32"):
        return StreamTrainer(cfg, params(), learning_rate=sched, weight_decay=wd,
                             train_lm_head=True, moment_dtype=moment)

    # The f32 stream run: the metrics, the parameters before and after each
    # step; a NaN batch after it.  A second run is the path's floor.
    hist, snaps = [], []
    st = stream()
    p0 = _snapshot(st)
    names = [n for n, _ in named_leaves(st.full_params("meta"))]
    _zero_launch_counts()
    for b in batches[:S]:
        hist.append(st.train_step(b, seed))
        snaps.append(_snapshot(st))
    launches = _launch_counts()
    want = {"flash_attention_fwd_f32": 2 * L, "flash_attention_bwd_dq_f32": L,
            "flash_attention_bwd_dkv_f32": L}
    check(_per_step(launches, S) == want,
          f"offload check: stream launches {launches} over {S} steps, want {want} a step")
    bad = dict(batches[0])
    bad["aux_balance_weight"] = np.full((OFFLOAD_SMALL_B, OFFLOAD_SMALL_T), np.nan, np.float32)
    before = [t.clone() for t in st.layers_host[0] + st.mu[0]]
    m_bad = st.train_step(bad, seed)
    check(m_bad["skipped"] == 1.0 and st.step == S and all(
        torch.equal(a, b) for a, b in zip(before, st.layers_host[0] + st.mu[0])),
        f"offload check: a NaN batch was not skipped: {m_bad}, step {st.step}")
    pinned_small = st.pinned_bytes
    st.close()
    del st, before
    again = stream()
    floor = []
    for i, b in enumerate(batches[:S]):
        again.train_step(b, seed)
        if i in (0, S - 1):
            floor.append(_leaf_diff(_snapshot(again), snaps[i]))
    again.close()
    del again
    deterministic = all(f[1] == 0 for f in floor)
    t_stream = time.perf_counter() - t_start

    # OffloadTrainer and Trainer, the same steps.
    others = {}
    ot = OffloadTrainer(cfg, params(), OffloadAdamW(learning_rate=sched, weight_decay=wd))
    others["offload"] = ([ot.train_step(b, seed) for b in batches[:S]],
                         [t.detach() for _, t in named_leaves(ot.state.params)])
    pinned_offload = ot.pinned_bytes
    ot.close()
    del ot
    torch.cuda.empty_cache()
    tr = Trainer(cfg, params(), TrainerConfig(learning_rate=lr, weight_decay=wd, warmup_steps=0,
                                               total_steps=total))
    th = []
    for b in batches[:S]:
        tr.state, m = train_step(tr.state, tr._place_batch(b), seed, cfg=cfg,
                                 optimizer=tr.optimizer, remat=True)
        th.append({k: float(v) for k, v in m.items()})
    others["trainer"] = (th, [t.detach() for _, t in named_leaves(tr.state.params)])
    del tr, th
    torch.cuda.empty_cache()
    lines = []
    for name, (oh, op) in others.items():
        loss = max(abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in zip(oh, hist))
        gn = max(abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"] for a, b in zip(oh, hist))
        rest, bias, ok = _params_close(op, snaps[-1], names, lr_sum)
        check(loss <= OFFLOAD_LOSS_RTOL and gn <= OFFLOAD_GNORM_RTOL and ok
              and not any(h["skipped"] for h in oh),
              f"offload check: {name} vs stream: loss {loss}, grad norm {gn}, parameters "
              f"{rest} (k_proj biases {bias})")
        lines.append(f"{name}: losses relative {loss:.2e}, grad norms {gn:.2e}, parameters max "
                     f"|diff| {rest:.2e} (k_proj biases {bias:.2e})")
    del others
    t_others = time.perf_counter() - t_start - t_stream
    print(f"offload check [{card}]: {L} layers at flagship width, f32, B {OFFLOAD_SMALL_B} x "
          f"T {OFFLOAD_SMALL_T}, input jitter on, {S} steps: stream losses "
          f"{[round(h['loss'], 6) for h in hist]}, grad norms "
          f"{[round(h['grad_norm'], 4) for h in hist]}; against the stream trainer (limits "
          f"{OFFLOAD_LOSS_RTOL}, {OFFLOAD_GNORM_RTOL}, {OFFLOAD_PARAM_ATOL}): " + "; ".join(lines)
          + f"; f32 launches a step {_per_step(launches, S)}; a NaN batch skipped; pinned host "
          f"memory: stream {pinned_small / 1e9:.2f} GB, offload {pinned_offload / 1e9:.2f} GB; "
          f"the two stream runs {t_stream:.1f} s, offload and Trainer {t_others:.1f} s",
          flush=True)

    # int8 moments: step 1 against f32, step 2's update, resume.
    t0 = time.perf_counter()
    s8 = stream("int8")
    s8.train_step(batches[0], seed)
    d1 = _leaf_diff(_snapshot(s8), snaps[0])
    d1_rel = d1[2] / max(_leaf_diff(snaps[0], p0)[2], 1e-30)
    s8.train_step(batches[1], seed)
    p2 = _snapshot(s8)
    drift, worst = {}, ("", 0.0)
    for n, a8, a32, p1 in zip(names, p2, snaps[1], snaps[0]):
        u32, u8 = a32 - p1, a8 - p1
        if u32.abs().max() > 0:
            drift[n] = max(drift.get(n, 0.0), float((u8 - u32).norm() / u32.norm()))
            el = float((u8 - u32).abs().max() / u32.abs().max())
            worst = max(worst, (n, el), key=lambda x: x[1])
    del p2, snaps, p0
    s8.close()
    del s8
    # The checkpoint round trip at one layer: the same int8 path and leaves
    # (the embeddings and lm_head, most of the bytes, included).
    c1 = dataclasses.replace(cfg, text_config=dataclasses.replace(tc, num_hidden_layers=1))
    s1 = StreamTrainer(c1, params(c1), learning_rate=sched, weight_decay=wd, train_lm_head=True,
                       moment_dtype="int8")
    for b in batches[:2]:
        s1.train_step(b, seed)
    with tempfile.TemporaryDirectory() as ck:
        t1 = time.perf_counter()
        s1.save(ck)
        save_s = time.perf_counter() - t1
        ck_bytes = sum(os.path.getsize(os.path.join(ck, f)) for f in os.listdir(ck))
        p_ck = _snapshot(s1)
        for b in batches[2:S + 1]:
            s1.train_step(b, seed)
        straight = _snapshot(s1)
        s1.close()
        del s1
        t1 = time.perf_counter()
        resumed = StreamTrainer(c1, restore_dir=ck, learning_rate=sched, weight_decay=wd,
                                train_lm_head=True, moment_dtype="int8", param_dtype=f32)
        restore_s = time.perf_counter() - t1
    for b in batches[2:S + 1]:
        resumed.train_step(b, seed)
    res = _leaf_diff(_snapshot(resumed), straight)
    res_rel = res[2] / max(_leaf_diff(straight, p_ck)[2], 1e-30)
    resumed.close()
    del resumed, straight, p_ck
    if deterministic:
        check(d1[1] == 0 and res[1] == 0,
              f"int8 moments: first step differs from f32 in {d1[1]} elements, the resumed "
              f"run from the straight one in {res[1]} (deterministic path)")
    else:
        check(d1_rel <= TRAIN_ACCUM_REL and res_rel <= TRAIN_ACCUM_REL,
              f"int8 moments: first step vs f32 {d1_rel:.3e} of the update, resumed vs straight "
              f"{res_rel:.3e} of the last two updates (limit {TRAIN_ACCUM_REL}; floors {floor})")
    worst_l2 = max(drift.items(), key=lambda x: x[1])
    check(INT8_STEP_DRIFT_MIN <= worst_l2[1] < INT8_STEP_DRIFT and worst[1] < INT8_STEP_ELEMENT,
          f"int8 moments: second update's relative L2 by leaf {drift}, largest element's "
          f"difference {worst}")
    t_int8 = time.perf_counter() - t0

    # Card against the CPU, jitter off: the loss of one forward pass.
    t0 = time.perf_counter()
    ncfg = dataclasses.replace(cfg, text_config=dataclasses.replace(tc, input_jitter_noise=0.0))
    evals = []
    p = params(ncfg)
    for device, w in (("cuda", p), ("cpu", _to(p, device="cpu")),
                      ("cuda", _to(p, dtype=torch.bfloat16))):
        t = StreamTrainer(ncfg, w, device=device)
        evals.append(t.evaluate([batches[0]])["eval_loss"])
        t.close()
        del t, w
    del p
    loss_rel, bf16_rel = (abs(e - evals[1]) / abs(evals[1]) for e in (evals[0], evals[2]))
    check(loss_rel <= OFFLOAD_CPU_LOSS_REL < bf16_rel,
          f"stream trainer card vs CPU: loss relative {loss_rel}, the bf16 control {bf16_rel} "
          f"(limit {OFFLOAD_CPU_LOSS_REL}: f32 within, bf16 past it)")
    torch.cuda.empty_cache()
    print(f"offload check [{card}]: int8 moments: first step vs f32 {d1[1]} elements differ "
          f"(max {d1[0]:.3e}, relative L2 {d1_rel:.3e} of the update); second update against "
          f"f32's, relative L2 per leaf at most {worst_l2[1]:.4f} ({worst_l2[0]}; limits "
          f"{INT8_STEP_DRIFT_MIN} to {INT8_STEP_DRIFT}), largest element's difference over the "
          f"leaf's largest f32 move {worst[1]:.3f} ({worst[0]}; limit {INT8_STEP_ELEMENT}); at "
          f"one layer, 2 steps + save ({ck_bytes / 1e9:.2f} GB in {save_s:.2f} s) + restore ({restore_s:.2f} s) + 2 steps vs 4 straight: {res[1]} "
          f"elements differ (max {res[0]:.3e}, relative L2 {res_rel:.3e} of the last two "
          f"updates); two f32 runs differ in {[f[1] for f in floor]} elements"
          f"{' (bit-equal: deterministic path)' if deterministic else ''}; {t_int8:.1f} s; "
          f"stream trainer card vs CPU, f32, jitter off, `evaluate`: loss {evals[0]:.6f} vs "
          f"{evals[1]:.6f}, relative {loss_rel:.3e} (limit {OFFLOAD_CPU_LOSS_REL}); the bf16 "
          f"control on the card {evals[2]:.6f}, relative {bf16_rel:.3e}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def run_train_offload(card: str) -> dict:
    """`OffloadTrainer` on the 36-layer flagship (DEEP_* above), f32 moments
    in host memory.  Returns the launch counts of its steps."""
    import torch
    from unimoe_audio_torch.config import TextMoEConfig, UniMoEAudioConfig
    from unimoe_audio_torch.models.model import init_model_params
    from unimoe_audio_torch.train.offload import OffloadAdamW, OffloadTrainer

    cfg = UniMoEAudioConfig(text_config=TextMoEConfig(), vision_config=None)
    L = cfg.text_config.num_hidden_layers
    torch.cuda.empty_cache()
    print(f"train offload [{card}]: before: {_meminfo()}; {_pcie_rates()}", flush=True)
    t0 = time.perf_counter()
    params = init_model_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    n_params = sum(t.numel() for t in _leaves(params))
    tr = OffloadTrainer(cfg, params, OffloadAdamW(learning_rate=1e-4), remat=True)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    mem = _meminfo()
    batch = probe_batch(cfg)
    n = 1 + DEEP_TIMED_STEPS
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    hist, step_s = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        hist.append(tr.train_step(batch, 0))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
    launches = _launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {"flash_attention_fwd": 2 * L, "flash_attention_bwd_dq": L,
            "flash_attention_bwd_dkv": L, "flash_attention_bwd_dkv_reduce": L}
    check(_per_step(launches, n) == want, f"train offload: launches {launches} over {n} steps, "
          f"want {want} a step")
    losses = [h["loss"] for h in hist]
    check(all(np.isfinite(losses)) and not any(h["skipped"] for h in hist),
          f"train offload: losses {losses}, skipped {[h['skipped'] for h in hist]}")
    med = float(np.median(step_s[1:]))
    print(f"train offload [{card}]: OffloadTrainer, {L} layers ({n_params / 1e9:.3f} B params, "
          f"bf16 on the card), f32 moments in host memory ({tr.pinned_bytes / 1e9:.2f} GB "
          f"pinned), dense, remat, B {TRAIN_B} x T {TRAIN_T}, lr 1e-4: set-up {setup_s:.1f} s "
          f"({mem}); losses {[round(x, 4) for x in losses]}, grad norms "
          f"{[round(h['grad_norm'], 3) for h in hist]}; step times (s) "
          f"{[round(x, 3) for x in step_s]} (the first a warm-up), median timed {med:.3f} s, "
          f"{TRAIN_B * TRAIN_T / med:.1f} tokens/s; peak memory allocated {peak_gb:.2f} GB; "
          f"launches per step {_per_step(launches, n)}", flush=True)
    tr.close()
    del tr, params
    torch.cuda.empty_cache()
    print(f"train offload [{card}]: after release: {_meminfo()}", flush=True)
    return launches


def _stream_deep(card: str, layers: int, n: int):
    """StreamTrainer at `layers` layers of the flagship (DEEP_* above), n
    steps, the first a warm-up: (launch counts, peak GB, median timed step
    seconds (the warm-up's where n is 1), the printed line)."""
    import dataclasses

    import torch
    from unimoe_audio_torch.config import TextMoEConfig, UniMoEAudioConfig
    from unimoe_audio_torch.train.stream import StreamTrainer

    cfg = UniMoEAudioConfig(text_config=dataclasses.replace(
        TextMoEConfig(), num_hidden_layers=layers), vision_config=None)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    st = StreamTrainer(cfg, seed=0, learning_rate=1e-4, moment_dtype="int8")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    micro = [probe_batch(cfg, seed=s) for s in range(DEEP_MICRO)]
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    hist, step_s = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        hist.append(st.train_step(micro, 0))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
    launches = _launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    g = DEEP_MICRO
    want = {"flash_attention_fwd": 2 * layers * g, "flash_attention_bwd_dq": layers * g,
            "flash_attention_bwd_dkv": layers * g, "flash_attention_bwd_dkv_reduce": layers * g}
    check(_per_step(launches, n) == want, f"train stream ({layers} layers): launches {launches} "
          f"over {n} steps, want {want} a step")
    losses = [h["loss"] for h in hist]
    check(all(np.isfinite(losses)) and not any(h["skipped"] for h in hist) and st.step == n,
          f"train stream ({layers} layers): losses {losses}, skipped "
          f"{[h['skipped'] for h in hist]}, applied {st.step}")
    med = float(np.median(step_s[1:] or step_s))
    line = (f"train stream [{card}]: StreamTrainer, {layers} layers, bf16, int8 moments, {g} "
            f"micro-batches of B {TRAIN_B} x T {TRAIN_T} a step, lm_head frozen, lr 1e-4: "
            f"{st.pinned_bytes / 1e9:.2f} GB pinned, set-up {setup_s:.1f} s ({_meminfo()}); "
            f"losses {[round(x, 4) for x in losses]}, grad norms "
            f"{[round(h['grad_norm'], 3) for h in hist]}; step times (s) "
            f"{[round(x, 3) for x in step_s]} (the first a warm-up), median timed {med:.3f} s, "
            f"{g * TRAIN_B * TRAIN_T / med:.1f} tokens/s; peak memory allocated {peak_gb:.3f} "
            f"GB; launches per step {_per_step(launches, n)}") if n > 1 else (
            f"train stream [{card}]: StreamTrainer, {layers} layers, the same, one step (for its "
            f"peak memory): {st.pinned_bytes / 1e9:.2f} GB pinned, set-up {setup_s:.1f} s; loss "
            f"{losses[0]:.4f}, grad norm {hist[0]['grad_norm']:.3f}, {step_s[0]:.3f} s (a "
            f"warm-up); peak memory allocated {peak_gb:.3f} GB; launches {launches}")
    st.close()
    del st
    torch.cuda.empty_cache()
    return launches, peak_gb, med, line


def run_train_stream(card: str) -> dict:
    """`StreamTrainer` on the 36-layer flagship and at STREAM_SHALLOW_LAYERS
    layers (DEEP_* above): the device memory's growth with depth.  Returns
    the launch counts of the 36-layer steps."""
    from unimoe_audio_torch.config import TextMoEConfig

    tc = TextMoEConfig()
    L = tc.num_hidden_layers
    launches, peak, _, line = _stream_deep(card, L, 1 + DEEP_TIMED_STEPS)
    print(line, flush=True)
    _, peak_s, _, line_s = _stream_deep(card, STREAM_SHALLOW_LAYERS, 1)
    print(line_s, flush=True)
    boundary_gb = TRAIN_B * TRAIN_T * tc.hidden_size * 2 / 1e9
    limit = (L - STREAM_SHALLOW_LAYERS) * boundary_gb * DEPTH_MARGIN
    check(peak - peak_s <= limit, f"train stream: peak memory {peak:.3f} GB at {L} layers vs "
          f"{peak_s:.3f} GB at {STREAM_SHALLOW_LAYERS}: grows by more than {limit:.3f} GB")
    print(f"train stream [{card}]: peak memory allocated {peak:.3f} GB at {L} layers, "
          f"{peak_s:.3f} GB at {STREAM_SHALLOW_LAYERS}: +{peak - peak_s:.3f} GB (limit "
          f"{limit:.3f} GB: {DEPTH_MARGIN} x {L - STREAM_SHALLOW_LAYERS} boundary activations of "
          f"{boundary_gb * 1e3:.1f} MB)", flush=True)
    return launches


def check_sliding_window(card: str) -> None:
    """The sliding-window witness (SLIDING_* above): greedy `generate` of a
    2-layer flagship-width f32 model with one sliding layer, card vs CPU."""
    import dataclasses

    import torch
    from unimoe_audio_torch.codec import delay as dl
    from unimoe_audio_torch.config import TextMoEConfig, UniMoEAudioConfig
    from unimoe_audio_torch.generate.loop import generate, pad_buffer
    from unimoe_audio_torch.models.model import init_model_params

    tc = dataclasses.replace(TextMoEConfig(), num_hidden_layers=len(SLIDING_LAYER_TYPES),
                             use_sliding_window=True, sliding_window=SLIDING_WINDOW,
                             layer_types=SLIDING_LAYER_TYPES)
    cfg = UniMoEAudioConfig(text_config=tc, vision_config=None)
    params = init_model_params(cfg, seed=9, dtype=torch.float32, device="cuda")
    rng = np.random.default_rng(9)
    B = 2
    ids = rng.integers(0, tc.vocab_size - 8, size=(2 * B, SLIDING_T_TEXT))
    mask = np.ones_like(ids)
    mask[0, :20] = 0
    prefill, steps = dl.prepare_audio_prompt(
        [None] * B, num_channels=cfg.codec_channels, bos_value=cfg.codec_bos_value,
        delay_pattern=cfg.codec_delay_pattern)
    runs, tapes = [], []
    counts = _launch_counts()
    for device in ("cuda", "cpu"):
        p = params if device == "cuda" else _to(params, device="cpu")
        tape: list = []
        with torch.inference_mode(), first_decode_logits() as logits, \
                router_tape(tape, tapes[0] if tapes else None):
            res = generate(p, cfg, torch.as_tensor(ids, device=device),
                           torch.as_tensor(mask, device=device), None,
                           pad_buffer(torch.as_tensor(prefill, device=device), SLIDING_FRAMES),
                           steps, torch.Generator(device=device).manual_seed(0),
                           max_tokens=SLIDING_FRAMES, min_tokens=SLIDING_FRAMES, cfg_scale=3.0,
                           temperature=1.0, top_p=1.0, cfg_filter_top_k=45,
                           eos_prob_mul_factor=1.0, do_sample=False)
        runs.append((res.codes.cpu(), res.lengths.cpu(), logits[0]))
        tapes.append(tape)
        del p
    k1 = {k: v - counts[k] for k, v in _launch_counts().items()
          if k.startswith("flash_attention_fwd") and v != counts[k]}
    err = _rel(runs[0][2], runs[1][2])
    equal = torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    router_err, flips = replay_report(*tapes, tc, torch.as_tensor(mask.reshape(-1) > 0))
    check(err <= SLIDING_REL_L2 and router_err < VT2M_REF_REL_L2 and equal and not k1,
          f"sliding-window witness: first decode logits relative L2 {err}, router logits "
          f"{router_err}, frames equal {equal}, K1 launches {k1}")
    print(f"reference check [{card}]: sliding-window witness, layers {SLIDING_LAYER_TYPES} at "
          f"flagship width, window {SLIDING_WINDOW}, f32, greedy prefill of {SLIDING_T_TEXT} "
          f"tokens (one row left-padded by 20) and {SLIDING_FRAMES} frames, card vs CPU under "
          f"the card's routing: first decode step's codec logits relative L2 {err:.3e} (limit "
          f"{SLIDING_REL_L2}), router logits {router_err:.3e} (limit {VT2M_REF_REL_L2}), frames "
          f"equal, no K1 launch; route_flips over {len(flips)} calls: {sum(flips)} "
          f"(by call, nonzero: {[(i, f) for i, f in enumerate(flips) if f]})", flush=True)
    del params
    torch.cuda.empty_cache()


def run_slice(card: str, out_dir: str):
    """The flagship text-to-music path, wavs into out_dir; returns
    (model, prompts, launch counts)."""
    import torch
    from unimoe_audio_torch.api import UniMoEAudio
    from unimoe_audio_torch.config import TextMoEConfig, UniMoEAudioConfig
    from unimoe_audio_torch.ops.flash_attention import flash_attention

    cfg = UniMoEAudioConfig(text_config=TextMoEConfig())
    tc, vcfg = cfg.text_config, cfg.vision_config
    t0 = time.perf_counter()
    model = UniMoEAudio(allow_random=True, config=cfg, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(model.params))
    n_vision = sum(t.numel() for t in _leaves(model.params["vision"]))
    print(f"slice: flagship UniMoEAudio ({tc.num_hidden_layers} layers, hidden "
          f"{tc.hidden_size}; vision tower {vcfg.depth} blocks, hidden {vcfg.hidden_size}; "
          f"{n_params / 1e9:.2f} B params bf16, {n_vision / 1e9:.3f} B of them the tower) built "
          f"in {time.perf_counter() - t0:.1f} s; weights resident by dtype (GB) "
          f"{_weight_gb(model.params)}", flush=True)

    captions = [caption(n) for n in (58, 74, 90, 106)]
    # Warm-up: one short call (cuBLAS / cuDNN plans, allocator).
    model.text_to_music(captions, output_dir=out_dir, save_name="warmup", seed=1,
                        max_audio_seconds=1, min_audio_seconds=0.5)

    _zero_launch_counts()
    paths = model.text_to_music(captions, output_dir=out_dir, seed=0,
                                max_audio_seconds=11, min_audio_seconds=6)
    launches = _launch_counts()
    t = model.last_timings
    codes = model.last_codes

    prefills = 1
    check(launches["flash_attention_fwd"] == tc.num_hidden_layers * prefills,
          f"flash launches {launches['flash_attention_fwd']} != "
          f"{tc.num_hidden_layers} x {prefills} prefill")
    check(launches["flash_attention_bwd_dq"] == launches["flash_attention_bwd_dkv"]
          == launches["flash_attention_bwd_dkv_reduce"] == 0,
          f"generation launched a backward kernel: {launches}")
    check(t["steps"] > 256, f"decode took {t['steps']} steps: no chunk boundary crossed")
    check(len(paths) == len(captions), "one wav per caption")
    hop = model.dac.config.hop_length
    for p, n, c in zip(paths, t["lengths"], codes):
        check(os.path.isfile(p), f"missing wav {p}")
        check(c.shape == (n, cfg.codec_channels), f"codes shape {c.shape}")
        check(bool((c >= 0).all() and (c < model.dac.config.codebook_size).all()),
              "codes out of range")
        with wave.open(p) as f:
            n_samples = f.getnframes()
            pcm = np.frombuffer(f.readframes(n_samples), "<i2")
        check(n_samples == n * hop, f"{p}: {n_samples} samples != {n} frames x {hop}")
        check(int(np.abs(pcm).max()) > 0, f"{p}: silent")
    wav0 = model.dac.decode_array(codes[0].T[None])
    check(bool(np.isfinite(wav0).all()), "DAC output is not finite")

    audio_s = sum(t["lengths"]) / 50.0
    gen_s = t["prefill_s"] + t["decode_s"]
    print(f"slice: {len(captions)} requests (8 CFG rows), T_text 128, {t['steps']} decode steps, "
          f"frames {t['lengths']}; flash launches {launches['flash_attention_fwd']}", flush=True)
    print(f"slice: prefill {t['prefill_s'] * 1e3:.2f} ms; decode {t['decode_s'] * 1e3 / t['steps']:.2f} "
          f"ms/frame; aggregate realtime factor {audio_s / gen_s:.3f} "
          f"({audio_s:.2f} s of audio in {gen_s:.2f} s, prefill + decode); "
          f"DAC {t['dac_s'] * 1e3:.1f} ms  [{card}]", flush=True)
    prompts = _t2m_prompts(captions)

    # The same prefill PREFILL_REPEATS more times, in short calls after the
    # launch counts were read: the spread around the one reading above.
    ids, mask = model._tokenize(prompts)
    reps = []
    for i in range(PREFILL_REPEATS):
        model._generate_core(ids, mask, None, "prefill", output_dir=out_dir, cfg_scale=10.0,
                             seed=3 + i, max_tokens=30, min_tokens=15)
        reps.append(model.last_timings["prefill_s"] * 1e3)
    print(f"slice: prefill repeated {PREFILL_REPEATS} x (ms): "
          f"{', '.join(f'{x:.2f}' for x in reps)}; median {float(np.median(reps)):.2f}  "
          f"[{card}]", flush=True)
    return model, prompts, launches


def _two_tone_wav(path: str, seconds: float, sr: int) -> None:
    """A voice-prompt stand-in: two tones, written as 16-bit PCM."""
    from unimoe_audio_torch.codec import audio_io

    t = np.arange(int(seconds * sr)) / sr
    audio_io.write_wav(path, 0.3 * np.sin(2 * np.pi * 220 * t)
                       + 0.2 * np.sin(2 * np.pi * 331 * t), sr)


def run_tts(model, card: str, out_dir: str):
    """Voice-clone TTS through `UniMoEAudio.text_to_speech` on the flagship
    model of the T2M phase: a TTS_PROMPT_SECONDS reference wav at
    TTS_PROMPT_SR (read, resampled to 16 kHz, encoded by the DAC), its
    codes scattered into the prompt's placeholder slots, the CFG-paired
    prefill through K1, the decode and the wavs.  Checks 36 K1 launches in
    the one prefill, the prompt bucket, every wav (its length and finite
    audio); then K1 at this prefill's shape and the two reference checks
    against the CPU.  Returns (launch counts, K1's record at this shape)."""
    import torch

    tc = model.config.text_config
    wav = os.path.join(out_dir, "voice_prompt.wav")
    _two_tone_wav(wav, TTS_PROMPT_SECONDS, TTS_PROMPT_SR)
    kw = dict(prompt_text=TTS_PROMPT_TEXT, prompt_wav=wav, output_dir=out_dir, cfg_scale=1.0)
    model.text_to_speech(TTS_SENTENCES, save_name="tts_warmup", seed=1, max_audio_seconds=0.5,
                         **kw)
    captured: dict = {}
    _capture_core(model, captured)
    _zero_launch_counts()
    try:
        paths = model.text_to_speech(TTS_SENTENCES, seed=0, max_audio_seconds=TTS_SECONDS, **kw)
    finally:
        del model._generate_core
    launches = _launch_counts()
    t = model.last_timings
    check(launches["flash_attention_fwd"] == tc.num_hidden_layers,
          f"TTS: flash launches {launches['flash_attention_fwd']} != {tc.num_hidden_layers} "
          "(one per layer in the one prefill)")
    check(launches["flash_attention_bwd_dq"] == launches["flash_attention_bwd_dkv"] == 0,
          f"TTS launched a backward kernel: {launches}")
    ids, mask = captured["ids"], captured["mask"]
    n_ph = int((ids == model.config.codec_placeholder_value).sum())
    check(ids.shape == (2 * len(TTS_SENTENCES), t["T_text"]) and 128 < t["T_text"] <= 256,
          f"TTS prompt shape {ids.shape}: not 8 rows in the 192-256 buckets")
    check(n_ph == captured["codec"].shape[0] and n_ph > 0, "TTS: placeholder count")
    check(len(paths) == len(TTS_SENTENCES), "TTS: one wav per sentence")
    hop, sr = model.dac.config.hop_length, model.dac.config.sample_rate
    max_frames = int(TTS_SECONDS * 50)
    for p, n, c in zip(paths, t["lengths"], model.last_codes):
        check(os.path.isfile(p), f"missing wav {p}")
        check(0 < n <= max_frames and c.shape == (n, model.config.codec_channels),
              f"TTS: {n} frames, codes {c.shape}")
        with wave.open(p) as f:
            check(f.getnframes() == max(n * hop, sr),
                  f"{p}: {f.getnframes()} samples for {n} frames")
        audio = model.dac.decode_array(np.clip(c, 0, model.dac.config.codebook_size - 1).T[None])
        check(bool(np.isfinite(audio).all()), f"{p}: the waveform is not finite")
    audio_s = sum(t["lengths"]) / 50.0
    gen_s = t["dac_encode_s"] + t["prefill_s"] + t["decode_s"] + t["dac_s"]
    print(f"tts [{card}]: {len(TTS_SENTENCES)} sentences (8 CFG rows), prompt "
          f"{TTS_PROMPT_SECONDS} s at {TTS_PROMPT_SR} Hz -> {n_ph // len(ids)} placeholder rows a "
          f"CFG row, T_text {t['T_text']}, left pads {[int((m == 0).sum()) for m in mask]}; "
          f"{t['steps']} decode steps, frames {t['lengths']}; flash launches "
          f"{launches['flash_attention_fwd']}", flush=True)
    print(f"tts [{card}]: DAC encode {t['dac_encode_s'] * 1e3:.2f} ms; prefill "
          f"{t['prefill_s'] * 1e3:.2f} ms; decode {t['decode_s'] * 1e3 / t['steps']:.2f} ms/frame; "
          f"DAC decode {t['dac_s'] * 1e3:.1f} ms; realtime factor {audio_s / gen_s:.3f} "
          f"({audio_s:.2f} s of audio in {gen_s:.2f} s, encode + prefill + decode + DAC decode)",
          flush=True)
    rec = time_flash(tc, mask, launches, card, "TTS")
    check_dac_encode_reference(model, wav, card)
    check_voice_clone_reference(model.config, ids, mask, captured["codec"], card)
    return launches, rec


def check_dac_encode_reference(model, wav: str, card: str) -> None:
    """The 16 kHz DAC's encode of the voice prompt on the card vs on the
    CPU with the same (card-made) weights: the share of equal codes.  A
    near tie of the codebook search can be decided otherwise, and changes
    every later codebook of that frame."""
    import torch
    from unimoe_audio_torch.codec.dac_wrapper import Dac

    cpu = Dac(allow_random=True, config=model.dac.config, device="cpu")
    cpu.params = _to(model.dac.params, device="cpu")
    got = np.asarray(model.dac.encode(wav))
    want = np.asarray(cpu.encode(wav))
    check(got.shape == want.shape, f"DAC encode shapes {got.shape} vs {want.shape}")
    share = float((got == want).mean())
    frames = np.flatnonzero((got != want).any(-1))
    print(f"reference check [{card}]: DAC encode of the {TTS_PROMPT_SECONDS} s prompt "
          f"({got.shape[0]} frames x {got.shape[1]} codebooks), card vs CPU: {share:.5f} of the "
          f"codes equal, {len(frames)} frames differ {frames[:8].tolist()} (floor "
          f"{DAC_ENCODE_EQUAL_SHARE})", flush=True)
    check(share >= DAC_ENCODE_EQUAL_SHARE, f"DAC encode: only {share} of the codes equal the CPU's")
    del cpu
    torch.cuda.empty_cache()


def check_voice_clone_reference(flag_cfg, ids, mask, flat_codec, card: str) -> None:
    """A 2-layer model at flagship width in f32 (weights made on the card,
    copied to the CPU), the TTS prefill of one CFG pair (the negative row
    and the first sentence's) with the voice prompt's codes scattered into
    the placeholder slots, card vs CPU: the codec logits over live rows
    within VOICE_REF_REL_L2."""
    import dataclasses

    import torch
    from unimoe_audio_torch.config import UniMoEAudioConfig
    from unimoe_audio_torch.models import model as M
    from unimoe_audio_torch.models.layers import KVCache

    cfg = dataclasses.replace(flag_cfg, text_config=dataclasses.replace(
        flag_cfg.text_config, num_hidden_layers=2))
    assert isinstance(cfg, UniMoEAudioConfig)
    tc = cfg.text_config
    gpu = M.init_model_params(cfg, seed=3, dtype=torch.float32, device="cuda")
    cpu = _to(gpu, device="cpu")
    rows = slice(0, 2)
    ids, mask = ids[rows], mask[rows]
    P = flat_codec.shape[0] // (2 * len(TTS_SENTENCES))
    aligned = M.align_codec_ids(ids, flat_codec[: 2 * P], cfg.codec_placeholder_value)
    B, T = ids.shape
    pos = np.where(mask == 0, 1, np.cumsum(mask, -1) - 1)
    live = torch.as_tensor(mask, dtype=torch.bool)

    def run(device, replay=None):
        params = cpu if device == "cpu" else gpu
        t = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=device)   # noqa: E731
        cache = KVCache.create(tc.num_hidden_layers, B, T + 2, tc.num_key_value_heads,
                               tc.head_dim, dtype=torch.float32, device=device)
        emb = M.calculate_input_embedding(params, t(ids), t(aligned), cfg.codec_placeholder_value)
        kv_valid = np.concatenate([mask, np.zeros((B, 2), mask.dtype)], -1)
        tape: list = []
        with router_tape(tape, replay):
            out = M.text_model_forward(params, emb, t(pos)[None].expand(3, B, T), tc,
                                       kv_cache=cache, cache_position=0,
                                       kv_valid_mask=t(kv_valid, torch.int32),
                                       padding_token_mask=t(mask, torch.int32))
        return M.codec_logits_from_hidden(params, out.last_hidden_state, cfg).cpu()[live], tape

    with torch.inference_mode():
        got, card_tape = run("cuda")
        want, cpu_tape = run("cpu", replay=card_tape)
    err = _rel(got, want)
    router_err, flips = replay_report(card_tape, cpu_tape, tc, live.reshape(-1))
    print(f"reference check [{card}]: 2-layer flagship-width voice-clone prefill, f32, one CFG "
          f"pair of the TTS batch (T {T}, {int((ids == cfg.codec_placeholder_value).sum())} "
          f"placeholder slots filled with the prompt's codes), card vs CPU under the card's "
          f"routing: codec logits relative L2 {err:.3e} (limit {VOICE_REF_REL_L2}), router "
          f"logits {router_err:.3e} (limit {VT2M_REF_REL_L2}); route_flips by layer {flips} "
          f"of {int(live.sum())} live tokens", flush=True)
    check(err < VOICE_REF_REL_L2 and router_err < VT2M_REF_REL_L2,
          f"voice-clone prefill, card vs CPU: relative L2 {err} (router logits {router_err})")
    del gpu, cpu
    torch.cuda.empty_cache()


def run_stream(model, card: str) -> dict:
    """Streaming T2M through `UniMoEAudio.text_to_music_stream` on the
    flagship: STREAM_FRAMES frames in chunks of STREAM_CHUNK, the time to
    the first chunk's audio and the launches (36 K1, one prefill); then
    `generate_stream` with greedy decoding against one `generate` call at
    the same cache length: the concatenated frames equal."""
    import torch
    from unimoe_audio_torch.api import T2M_NEGATIVE_CAPTION, t2m_prompt
    from unimoe_audio_torch.codec import delay as dl
    from unimoe_audio_torch.generate.loop import generate, pad_buffer
    from unimoe_audio_torch.generate.streaming import generate_stream

    tc, cfg = model.config.text_config, model.config
    limits = model.MAX_TOKENS, model.MIN_TOKENS
    model.MAX_TOKENS = model.MIN_TOKENS = STREAM_FRAMES
    text = caption(58)
    try:
        _zero_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chunks, stamps = [], []
        for chunk in model.text_to_music_stream(text, chunk_frames=STREAM_CHUNK, seed=0):
            stamps.append(time.perf_counter() - t0)
            chunks.append(chunk)
        launches = _launch_counts()
    finally:
        model.MAX_TOKENS, model.MIN_TOKENS = limits
    check(launches["flash_attention_fwd"] == tc.num_hidden_layers,
          f"stream: flash launches {launches['flash_attention_fwd']} != {tc.num_hidden_layers}")
    check(chunks[-1]["done"] and len(chunks) >= 3, f"stream: {len(chunks)} chunks")
    hop = model.dac.config.hop_length
    for c in chunks:
        if c["frames"].shape[1]:                   # a closing chunk may carry no frames
            check(c["audio"].shape == (1, c["frames"].shape[1] * hop)
                  and bool(np.isfinite(c["audio"]).all()), "stream: chunk audio shape or values")
    n = sum(c["frames"].shape[1] for c in chunks)
    print(f"stream [{card}]: text_to_music_stream, {STREAM_FRAMES} frames max in chunks of "
          f"{STREAM_CHUNK}: {len(chunks)} chunks, {n} frames; time to the first chunk's audio "
          f"{stamps[0] * 1e3:.1f} ms ({chunks[0]['frames'].shape[1]} frames); chunk times (s) "
          f"{[round(x, 3) for x in stamps]}; flash launches {launches['flash_attention_fwd']}",
          flush=True)

    ids, mask = model._tokenize([t2m_prompt(T2M_NEGATIVE_CAPTION), t2m_prompt(text)])
    knobs = dict(max_tokens=STREAM_FRAMES, min_tokens=STREAM_FRAMES, cfg_scale=10.0,
                 temperature=1.0, top_p=1.0, cfg_filter_top_k=45, eos_prob_mul_factor=0.6,
                 do_sample=False)
    counts = _launch_counts()
    with torch.inference_mode():
        streamed = np.concatenate([c["frames"] for c in generate_stream(
            model.params, cfg, ids, mask, None, torch.Generator(device="cuda"),
            chunk_frames=STREAM_CHUNK, **knobs)], axis=1)
        prefill, steps = dl.prepare_audio_prompt(
            [None], num_channels=cfg.codec_channels, bos_value=cfg.codec_bos_value,
            delay_pattern=cfg.codec_delay_pattern)
        res = generate(model.params, cfg, torch.as_tensor(ids, device="cuda"),
                       torch.as_tensor(mask, device="cuda"), None,
                       pad_buffer(torch.as_tensor(prefill, device="cuda"), STREAM_FRAMES), steps,
                       torch.Generator(device="cuda"), **knobs)
    _set_launch_counts(counts)
    (one,) = dl.generate_output(res.codes.cpu().numpy(), res.lengths.cpu().numpy(),
                                pad_value=cfg.codec_pad_value,
                                delay_pattern=cfg.codec_delay_pattern)
    check(streamed.shape[1] == one.shape[0] > STREAM_CHUNK and np.array_equal(streamed[0], one),
          f"greedy stream {streamed.shape} differs from one generate call {one.shape}")
    print(f"stream [{card}]: greedy generate_stream ({STREAM_CHUNK}-frame chunks) equals one "
          f"generate call at the same cache length: {one.shape[0]} frames x "
          f"{one.shape[1]} codebooks", flush=True)
    return launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def time_flash(tc, mask, launches, card, path: str):
    """K1 checked and timed at a path's prefill shape (its left-padded
    attention mask [B, T]): kernel, plain version and SDPA, each by CUDA
    events over back-to-back calls, and kernel and SDPA also by graph replay
    (`graph_ms`), with the bound."""
    import torch
    import torch.nn.functional as F
    from unimoe_audio_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference)

    B, T = mask.shape
    H, KV, Dh = tc.num_attention_heads, tc.num_key_value_heads, tc.head_dim
    q, k, v, vt = flash_inputs(B, H, KV, T, T, Dh, mask, seed=5)
    pads = [int((mask[b] == 0).sum()) for b in range(B)]
    err = check_flash(B, H, KV, T, T, Dh, pads, seed=5, valid=np.asarray(mask, np.int32))

    kk = k.repeat_interleave(H // KV, dim=1)
    vv = v.repeat_interleave(H // KV, dim=1)
    allowed = allowed_mask(vt, T, T)[:, None]                # [B, 1, T, S]
    count = flash_attention.launches
    ms = cuda_ms(lambda: flash_attention(q, k, v, vt), iters=200)
    graph = graph_ms(lambda: flash_attention(q, k, v, vt), 50)
    flash_attention.launches = count                          # timing launches are not the path's
    plain_ms = cuda_ms(lambda: flash_attention_reference(q, k, v, vt, True), iters=50)
    sdpa = lambda: F.scaled_dot_product_attention(q, kk, vv, attn_mask=allowed)   # noqa: E731
    library_ms = cuda_ms(sdpa, iters=200)
    library_graph = graph_ms(sdpa, 50)
    pairs = int(allowed_mask(vt, T, T).sum())                 # attended (query, key) pairs
    flops = 4 * Dh * H * pairs                                # QK^T and PV, 2 FLOP per MAC
    nbytes = (q.numel() + k.numel() + v.numel() + q.numel()) * 2 + vt.numel() * 4 \
        + 2 * B * H * T * 4                                   # q k v o bf16, mask, m l f32
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    for label, x in (("kernel", ms), ("kernel, graph", graph), ("sdpa", library_ms),
                     ("sdpa, graph", library_graph)):
        check_rate(f"flash_attention_fwd at the {path} prefill shape, {label}", x, nbytes, flops)
    rec = {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "unimoe_audio_torch/csrc/flash_attention_fwd.cu",
        "replaces": "unimoe_audio_tpu/ops/flash_attention.py:30",
        "launches": launches["flash_attention_fwd"],
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
        "device_ms_graph": graph,
        "library_device_ms_graph": library_graph,
    }

    def g(x):
        return "not measured" if x is None else f"{x:.4f} ms"

    print(f"kernel timing [{card}]: flash_attention_fwd at the {path} prefill shape B={B} H={H} "
          f"KV={KV} T=S={T} Dh={Dh}, pads {pads}: "
          f"kernel {ms:.4f} ms (graph replay, L2 cold: {g(graph)}), plain {plain_ms:.4f} ms, "
          f"sdpa {library_ms:.4f} ms (graph replay: {g(library_graph)}), bound "
          f"{rec['bound_ms']:.4f} ms by {rec['bound_by']} ({nbytes / 1e6:.2f} MB, "
          f"{flops / 1e9:.3f} GFLOP)", flush=True)
    print(json.dumps({"kernel": rec}), flush=True)
    return rec


def time_flash_bwd(launches: dict, errs: dict, card: str):
    """The dq and dk/dv kernels, their plain versions and one library call
    (the backward of scaled_dot_product_attention with expanded KV, which
    computes dq, dk and dv at once, the faster of its boolean-mask and
    is_causal forms) at the training slice's shape; K1 there too.  Returns the records of K2 and K3 and K1's
    training-shape fields."""
    import torch
    import torch.nn.functional as F
    from unimoe_audio_torch.config import TextMoEConfig
    from unimoe_audio_torch.ops import flash_attention as FA

    tc = TextMoEConfig()
    B, H, KV, T, Dh = TRAIN_B, tc.num_attention_heads, tc.num_key_value_heads, TRAIN_T, tc.head_dim
    args = bwd_inputs(B, H, KV, T, T, Dh, (0,) * B, True, seed=9)
    q, k, v, do, m, l, dvec, vt = args
    counts = _launch_counts()
    dq_ms = cuda_ms(lambda: FA.flash_attention_bwd_dq(*args, True), iters=20)
    dkv_ms = cuda_ms(lambda: FA.flash_attention_bwd_dkv(*args, True), iters=20)
    graph = {"flash_attention_bwd_dq": graph_ms(lambda: FA.flash_attention_bwd_dq(*args, True), 10),
             "flash_attention_bwd_dkv": graph_ms(
                 lambda: FA.flash_attention_bwd_dkv(*args, True), 10)}
    _set_launch_counts(counts)
    dq_plain = cuda_ms(lambda: FA.flash_attention_bwd_dq_reference(*args, True), iters=3, warmup=1)
    dkv_plain = cuda_ms(lambda: FA.flash_attention_bwd_dkv_reference(*args, True), iters=3,
                        warmup=1)
    qq = q.detach().requires_grad_(True)
    kk = k.repeat_interleave(H // KV, dim=1).detach().requires_grad_(True)
    vv = v.repeat_interleave(H // KV, dim=1).detach().requires_grad_(True)
    # The SDPA backward in the two forms that compute the same function here
    # (T = S, no padding), as for K1 below; the faster is the yardstick.
    lib_by_form = {}
    for form, kw in (("attn_mask", {"attn_mask": allowed_mask(vt, T, T)[:, None]}),
                     ("is_causal", {"is_causal": True})):
        out = F.scaled_dot_product_attention(qq, kk, vv, **kw)
        lib_by_form[form] = cuda_ms(
            lambda: torch.autograd.grad(out, (qq, kk, vv), do, retain_graph=True), iters=10)
        del out
    lib_ms = min(lib_by_form.values())
    # The SDPA backward computes dq, dk and dv: five products over the pairs.
    lib_bytes = (q.numel() + k.numel() + v.numel() + do.numel()) * 2 * 2
    for form, x in lib_by_form.items():
        check_rate(f"sdpa backward ({form}) at the training shape", x, lib_bytes,
                   2 * Dh * int(allowed_mask(vt, T, T).sum()) * H * 5)

    pairs = int(allowed_mask(vt, T, T).sum()) * H           # attended (query, key) pairs

    # K1 at this shape too: its fields join K1's record (kept at the T2M
    # prefill shape).  SDPA in two forms that compute the same function here
    # (T = S, no padding): the explicit boolean mask, and is_causal=True,
    # which lets PyTorch pick its flash backend; the faster is the yardstick.
    count = FA.flash_attention.launches
    fwd_ms = cuda_ms(lambda: FA.flash_attention(q, k, v, vt), iters=20)
    FA.flash_attention.launches = count
    fwd_dev = graph_ms(lambda: FA.flash_attention(q, k, v, vt), 10)
    FA.flash_attention.launches = count
    fwd_plain = cuda_ms(lambda: FA.flash_attention_reference(q, k, v, vt, True), iters=3, warmup=1)
    with torch.no_grad():
        sdpa_mask_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, kk, vv, attn_mask=allowed_mask(vt, T, T)[:, None]), iters=20)
        sdpa_causal_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, kk, vv, is_causal=True), iters=20)
    fwd_bytes = (2 * q.numel() + k.numel() + v.numel()) * 2 + (2 * B * H * T + vt.numel()) * 4
    fwd_t = (fwd_bytes / PEAK_BYTES_PER_S * 1e3, 4 * Dh * pairs / PEAK_BF16_FLOPS * 1e3)
    fwd_train = {
        "shape": f"B={B} H={H} KV={KV} T=S={T} Dh={Dh} causal",
        "ms": fwd_ms,
        "device_ms_graph": fwd_dev,
        "plain_ms": fwd_plain,
        "bound_ms": max(fwd_t),
        "bound_by": "bytes" if fwd_t[0] >= fwd_t[1] else "operations",
        "library_ms": min(sdpa_mask_ms, sdpa_causal_ms),
        "library_ms_attn_mask": sdpa_mask_ms,
        "library_ms_is_causal": sdpa_causal_ms,
    }
    for label, x in (("kernel", fwd_ms), ("kernel, graph", fwd_dev),
                     ("sdpa attn_mask", sdpa_mask_ms), ("sdpa is_causal", sdpa_causal_ms)):
        check_rate(f"flash_attention_fwd at the training shape, {label}", x, fwd_bytes,
                   4 * Dh * pairs)
    print(f"kernel timing [{card}]: flash_attention_fwd at the training shape B={B} H={H} "
          f"KV={KV} T=S={T} Dh={Dh} causal: kernel {fwd_ms:.4f} ms "
          f"({100 * max(fwd_t) / fwd_ms:.1f} % of the bound, "
          f"{4 * Dh * pairs / fwd_ms / 1e9:.1f} TFLOP/s; graph replay, L2 cold "
          f"{'not measured' if fwd_dev is None else f'{fwd_dev:.4f} ms'}), plain {fwd_plain:.4f} ms, "
          f"sdpa with attn_mask {sdpa_mask_ms:.4f} ms, sdpa is_causal {sdpa_causal_ms:.4f} ms, "
          f"bound {max(fwd_t):.4f} ms by {fwd_train['bound_by']} ({fwd_bytes / 1e6:.2f} MB, "
          f"{4 * Dh * pairs / 1e9:.3f} GFLOP); launches in the dense run "
          f"{launches['flash_attention_fwd']}",
          flush=True)

    in_bytes = (q.numel() + k.numel() + v.numel() + do.numel()) * 2 \
        + (m.numel() + l.numel() + dvec.numel() + vt.numel()) * 4
    recs = []
    for name, ms, plain, n_products, out_bytes, err in (
            ("flash_attention_bwd_dq", dq_ms, dq_plain, 3, q.numel() * 2, errs["dq"]),
            ("flash_attention_bwd_dkv", dkv_ms, dkv_plain, 4, (k.numel() + v.numel()) * 2,
             max(errs["dk"], errs["dv"]))):
        flops = 2 * Dh * pairs * n_products
        nbytes = in_bytes + out_bytes
        check_rate(f"{name} at the training shape, kernel", ms, nbytes, flops)
        check_rate(f"{name} at the training shape, kernel, graph", graph[name], nbytes, flops)
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_BF16_FLOPS * 1e3
        rec = {
            "name": name,
            "route": "cuda",
            "source": "unimoe_audio_torch/csrc/flash_attention_bwd.cu",
            "replaces": ("unimoe_audio_tpu/ops/flash_attention.py:150" if name.endswith("dq")
                         else "unimoe_audio_tpu/ops/flash_attention.py:208"),
            "launches": launches[name],
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms,
            "library_ms_attn_mask": lib_by_form["attn_mask"],
            "library_ms_is_causal": lib_by_form["is_causal"],
            "device_ms_graph": graph[name],
        }
        g = graph[name]
        print(f"kernel timing [{card}]: {name} B={B} H={H} KV={KV} T=S={T} Dh={Dh} causal: "
              f"kernel {ms:.4f} ms (graph replay, L2 cold: "
              f"{'not measured' if g is None else f'{g:.4f} ms'}), plain {plain:.4f} ms, "
              f"sdpa backward (dq, dk, dv) with "
              f"attn_mask {lib_by_form['attn_mask']:.4f} ms, is_causal "
              f"{lib_by_form['is_causal']:.4f} ms, bound {rec['bound_ms']:.4f} ms by {rec['bound_by']} "
              f"({nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP, "
              f"{flops / ms / 1e9:.1f} TFLOP/s, {100 * rec['bound_ms'] / ms:.1f} % of the bound)",
              flush=True)
        print(json.dumps({"kernel": rec}), flush=True)
        recs.append(rec)
    return recs, fwd_train



def time_flash_f32(t2m_mask, errs: dict, card: str) -> list:
    """The f32 kernels (csrc/flash_attention_f32.cu and
    csrc/flash_attention_bwd_f32.cu), their plain versions and SDPA in f32
    (TF32 off) as the library call: K1 at the T2M prefill
    shape (its attention mask) and at the training shape, K2 and K3 at the
    training shape; CUDA events over back-to-back calls and graph replays
    (`graph_ms`).  Each bound takes the rate of the kernels' 3xTF32
    products on the tensor cores (PEAK_3XTF32_FLOPS), with the bound at the
    CUDA cores' f32 rate beside it (`bound_ms_cuda_cores`).  Returns the
    records of the three kernels (K1's training-shape fields under
    train_shape)."""
    import torch
    import torch.nn.functional as F
    from unimoe_audio_torch.config import TextMoEConfig
    from unimoe_audio_torch.ops import flash_attention as FA

    f32 = torch.float32
    tc = TextMoEConfig()
    H, KV, Dh = tc.num_attention_heads, tc.num_key_value_heads, tc.head_dim
    src = "unimoe_audio_torch/csrc/flash_attention_f32.cu"
    bwd_src = "unimoe_audio_torch/csrc/flash_attention_bwd_f32.cu"
    rep = "unimoe_audio_tpu/ops/flash_attention.py:"

    def bound(nbytes, flops, peak=PEAK_F32_FLOPS):
        t = (nbytes / PEAK_BYTES_PER_S * 1e3, flops / peak * 1e3)
        return max(t), "bytes" if t[0] >= t[1] else "operations"

    def g(x):
        return "not measured" if x is None else f"{x:.4f} ms"

    def fwd_times(B, T, mask, seed, iters):
        q, k, v, vt = flash_inputs(B, H, KV, T, T, Dh, mask, seed, f32)
        counts = _launch_counts()
        ms = cuda_ms(lambda: FA.flash_attention(q, k, v, vt), iters=iters)
        graph = graph_ms(lambda: FA.flash_attention(q, k, v, vt), max(iters // 4, 10))
        _set_launch_counts(counts)
        plain = cuda_ms(lambda: FA.flash_attention_reference(q, k, v, vt, True),
                        iters=max(iters // 4, 3), warmup=1)
        kk = k.repeat_interleave(H // KV, dim=1)
        vv = v.repeat_interleave(H // KV, dim=1)
        allowed = allowed_mask(vt, T, T)[:, None]
        with torch.no_grad():
            lib = {"attn_mask": cuda_ms(lambda: F.scaled_dot_product_attention(
                q, kk, vv, attn_mask=allowed), iters=iters)}
            if not bool((vt == 0).any()):
                lib["is_causal"] = cuda_ms(lambda: F.scaled_dot_product_attention(
                    q, kk, vv, is_causal=True), iters=iters)
        pairs = int(allowed_mask(vt, T, T).sum()) * H
        flops = 4 * Dh * pairs
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * 4 + vt.numel() * 4 + 2 * B * H * T * 4
        for form, x in lib.items():
            check_rate(f"sdpa f32 ({form}) B={B} T={T}", x, nbytes, flops, PEAK_TF32_FLOPS)
        check_rate(f"flash_attention_fwd_f32 B={B} T={T}, kernel", ms, nbytes, flops,
                   PEAK_3XTF32_FLOPS)
        check_rate(f"flash_attention_fwd_f32 B={B} T={T}, kernel, graph", graph, nbytes, flops,
                   PEAK_3XTF32_FLOPS)
        b, by = bound(nbytes, flops, PEAK_3XTF32_FLOPS)
        b67, _ = bound(nbytes, flops)
        print(f"kernel timing [{card}]: flash_attention_fwd_f32 B={B} H={H} KV={KV} T=S={T} "
              f"Dh={Dh}: kernel {ms:.4f} ms (graph replay, L2 cold: {g(graph)}; "
              f"{flops / ms / 1e9:.2f} TFLOP/s), plain {plain:.4f} ms, sdpa f32 "
              + ", ".join(f"{f} {x:.4f} ms" for f, x in lib.items())
              + f", bound {b:.4f} ms by {by} ({nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP at "
              f"{PEAK_3XTF32_FLOPS / 1e12:.0f} TFLOP/s, 3xTF32; {b67:.4f} ms at the CUDA cores' "
              f"{PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s)", flush=True)
        return {"ms": ms, "device_ms_graph": graph, "plain_ms": plain, "bound_ms": b,
                "bound_by": by, "bound_ms_cuda_cores": b67, "library_ms": min(lib.values()),
                **{f"library_ms_{f}": x for f, x in lib.items()}}

    B, T = t2m_mask.shape
    prefill = fwd_times(B, T, np.asarray(t2m_mask, np.int32), 5, 200)
    train = fwd_times(TRAIN_B, TRAIN_T, np.ones((TRAIN_B, TRAIN_T), np.int32), 9, 20)
    fwd = {"name": "flash_attention_fwd_f32", "route": "cuda", "source": src,
           "replaces": rep + "30", "max_abs_err": errs["fwd"], **prefill,
           "shape": f"T2M prefill B={B} H={H} KV={KV} T=S={T} Dh={Dh} causal",
           "train_shape": {"shape": f"B={TRAIN_B} H={H} KV={KV} T=S={TRAIN_T} Dh={Dh} causal",
                           **train}}

    Bt, T = TRAIN_B, TRAIN_T
    args = bwd_inputs(Bt, H, KV, T, T, Dh, (0,) * Bt, True, seed=9, dtype=f32)
    q, k, v, do, m, l, dvec, vt = args
    counts = _launch_counts()
    times = {"flash_attention_bwd_dq_f32": (
                 cuda_ms(lambda: FA.flash_attention_bwd_dq(*args, True), iters=10),
                 graph_ms(lambda: FA.flash_attention_bwd_dq(*args, True), 5)),
             "flash_attention_bwd_dkv_f32": (
                 cuda_ms(lambda: FA.flash_attention_bwd_dkv(*args, True), iters=10),
                 graph_ms(lambda: FA.flash_attention_bwd_dkv(*args, True), 5))}
    _set_launch_counts(counts)
    plain = {"flash_attention_bwd_dq_f32": cuda_ms(
                 lambda: FA.flash_attention_bwd_dq_reference(*args, True), iters=3, warmup=1),
             "flash_attention_bwd_dkv_f32": cuda_ms(
                 lambda: FA.flash_attention_bwd_dkv_reference(*args, True), iters=3, warmup=1)}
    qq = q.detach().requires_grad_(True)
    kk = k.repeat_interleave(H // KV, dim=1).detach().requires_grad_(True)
    vv = v.repeat_interleave(H // KV, dim=1).detach().requires_grad_(True)
    lib = {}
    for form, kw in (("attn_mask", {"attn_mask": allowed_mask(vt, T, T)[:, None]}),
                     ("is_causal", {"is_causal": True})):
        out = F.scaled_dot_product_attention(qq, kk, vv, **kw)
        lib[form] = cuda_ms(lambda: torch.autograd.grad(out, (qq, kk, vv), do, retain_graph=True),
                            iters=5)
        del out
    pairs = int(allowed_mask(vt, T, T).sum()) * H
    in_bytes = (q.numel() + k.numel() + v.numel() + do.numel()) * 4 \
        + (m.numel() + l.numel() + dvec.numel() + vt.numel()) * 4
    for form, x in lib.items():       # five products over the pairs: dq, dk and dv at once
        check_rate(f"sdpa f32 backward ({form})", x, in_bytes, 2 * Dh * pairs * 5,
                   PEAK_TF32_FLOPS)
    recs = [fwd]
    for name, n_products, out_bytes, err in (
            ("flash_attention_bwd_dq_f32", 3, q.numel() * 4, errs["dq"]),
            ("flash_attention_bwd_dkv_f32", 4, (k.numel() + v.numel()) * 4,
             max(errs["dk"], errs["dv"]))):
        ms, graph = times[name]
        flops, nbytes = 2 * Dh * pairs * n_products, in_bytes + out_bytes
        check_rate(f"{name}, kernel", ms, nbytes, flops, PEAK_3XTF32_FLOPS)
        check_rate(f"{name}, kernel, graph", graph, nbytes, flops, PEAK_3XTF32_FLOPS)
        b, by = bound(nbytes, flops, PEAK_3XTF32_FLOPS)
        b67, _ = bound(nbytes, flops)
        rec = {"name": name, "route": "cuda", "source": bwd_src,
               "replaces": rep + ("150" if name.endswith("dq_f32") else "208"),
               "max_abs_err": err, "ms": ms, "plain_ms": plain[name], "bound_ms": b,
               "bound_by": by, "bound_ms_cuda_cores": b67, "library_ms": min(lib.values()),
               **{f"library_ms_{f}": x for f, x in lib.items()}, "device_ms_graph": graph,
               "shape": f"B={Bt} H={H} KV={KV} T=S={T} Dh={Dh} causal"}
        print(f"kernel timing [{card}]: {name} B={Bt} H={H} KV={KV} T=S={T} Dh={Dh} causal: "
              f"kernel {ms:.4f} ms (graph replay, L2 cold: {g(graph)}; "
              f"{flops / ms / 1e9:.2f} TFLOP/s), plain {plain[name]:.4f} ms, sdpa f32 backward "
              f"(dq, dk, dv) attn_mask {lib['attn_mask']:.4f} ms, is_causal "
              f"{lib['is_causal']:.4f} ms, bound {b:.4f} ms by {by} ({nbytes / 1e6:.2f} MB, "
              f"{flops / 1e9:.3f} GFLOP at {PEAK_3XTF32_FLOPS / 1e12:.0f} TFLOP/s, 3xTF32; "
              f"{b67:.4f} ms at the CUDA cores' {PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s)", flush=True)
        recs.append(rec)
    for rec in recs:
        print(json.dumps({"kernel": rec}), flush=True)
    return recs

def flagship_group_sizes(S: int, seed: int):
    """`moe_ffn_gmm`'s group sizes for S tokens routed by the flagship router
    (Top-P over 8 routed + 1 null expert, the eval mixer) on random hidden
    states, with a router weight of the flagship's init scale; returns
    (group_sizes int32 [8] on the card, rows A = ceil(8 S / 128) x 128)."""
    import torch
    from unimoe_audio_torch.config import TextMoEConfig
    from unimoe_audio_torch.moe import router as R
    from unimoe_audio_torch.moe.dispatch import gmm_group_sizes

    tc = TextMoEConfig()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    h = torch.randn(S, tc.hidden_size, generator=gen, device="cuda")
    wg = torch.randn(tc.hidden_size, tc.num_experts, generator=gen, device="cuda") \
        * tc.initializer_range
    logits = (h @ wg)[:, :tc.num_dynamic_experts]
    top_k = R.dynamic_expert_selection(logits, tc.mlp_dynamic_top_p)
    _, mask = R.sparse_expert_mixer_eval(logits, top_k, jitter_eps=tc.router_jitter_noise)
    E = tc.mlp_dynamic_expert_num
    A = -(-S * E // 128) * 128
    return gmm_group_sizes(mask[:, :E], A), A


def grouped_operands(A, K, N, E, seed):
    """x [A, K] bf16, W [E, K, N] bf16 (1/sqrt(K) scale), dy [A, N] f32."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(A, K, generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn(E, K, N, generator=gen, device="cuda") * K ** -0.5).to(torch.bfloat16)
    dy = torch.randn(A, N, generator=gen, device="cuda")
    return x, w, dy


def check_grouped(label: str, A: int, K: int, N: int, sizes, seed: int) -> dict:
    """K4 (in its own configuration and in the other one), K4t and K5 vs
    their plain versions on the same inputs, each through its wrapper and
    once more into an output filled with NaN before the launch, so that an
    element the kernel does not write fails; K5 a second time into another
    NaN-filled output, which must equal the first bit for bit.  Elementwise
    limits and the relative L2 error of the whole output.  Returns the
    largest max |err| of each kernel."""
    import torch
    from unimoe_audio_torch.ops import grouped_gemm as GG

    gs = sizes if torch.is_tensor(sizes) else torch.tensor(sizes, dtype=torch.int32,
                                                           device="cuda")
    E = gs.numel()
    x, w, dy = grouped_operands(A, K, N, E, seed)
    dyb = dy.to(torch.bfloat16)
    config = GG.gmm_config(A)
    other = next(c for c in GG.GMM_CONFIGS if c != config)
    counts = _launch_counts()
    cases = (
        ("grouped_gemm_gmm", config, lambda: GG.gmm(x, w, gs),
         lambda o: GG.launch_gmm(x, w, gs, o, False), (A, N), torch.float32,
         lambda: GG.gmm_reference(x, w, gs)),
        ("grouped_gemm_gmm", other, lambda: GG.gmm(x, w, gs, config=other),
         lambda o: GG.launch_gmm(x, w, gs, o, False, config=other), (A, N), torch.float32,
         lambda: GG.gmm_reference(x, w, gs)),
        ("grouped_gemm_gmm_transposed", "f32 dy", lambda: GG.gmm(dy, w, gs, transpose_rhs=True),
         lambda o: GG.launch_gmm(dy, w, gs, o, True), (A, K), torch.bfloat16,
         lambda: GG.gmm_reference(dy, w, gs, transpose_rhs=True)),
        ("grouped_gemm_gmm_transposed", "bf16 dy", lambda: GG.gmm(dyb, w, gs, transpose_rhs=True),
         lambda o: GG.launch_gmm(dyb, w, gs, o, True), (A, K), torch.bfloat16,
         lambda: GG.gmm_reference(dyb, w, gs, transpose_rhs=True)),
        ("grouped_gemm_tgmm", "", lambda: GG.tgmm(x, dy, gs, E),
         lambda o: GG.launch_tgmm(x, dy, gs, o), (E, K, N), torch.bfloat16,
         lambda: GG.tgmm_reference(x, dy, gs, E)),
    )
    errs, rels = {}, {}
    for name, tag, wrapper, launch, shape, dtype, plain in cases:
        got = wrapper()
        filled = torch.full(shape, float("nan"), dtype=dtype, device="cuda")
        launch(filled)
        if name == "grouped_gemm_tgmm":
            again = torch.full(shape, float("nan"), dtype=dtype, device="cuda")
            launch(again)
            torch.cuda.synchronize()
            check(torch.equal(filled, again),
                  f"grouped {label} {name}: two launches on the same inputs differ")
        torch.cuda.synchronize()
        want = plain().float()
        for where, out in (("wrapper", got), ("NaN-filled output", filled)):
            o = out.float()
            what = f"grouped {label} {name} {tag} ({where})"
            check(o.shape == want.shape and bool(torch.isfinite(o).all()),
                  f"{what}: wrong shape or non-finite output")
            err = (o - want).abs()
            rel = ((o - want).norm() / want.norm().clamp_min(1e-30)).item()
            check(bool((err <= GMM_ATOL + GMM_RTOL * want.abs()).all()) and rel <= GMM_REL_L2,
                  f"{what}: max err {err.max().item()}, relative L2 {rel}")
            errs[name] = max(errs.get(name, 0.0), err.max().item())
            rels[name] = max(rels.get(name, 0.0), rel)
        del got, filled, want
    _set_launch_counts(counts)                 # not launches of a main path
    slots = GG.tgmm_workspace_slots(A, E)
    print(f"kernel check: grouped {label} A={A} K={K} N={N} groups {gs.tolist()}: K4 in "
          f"{config} (and {other}) configuration, {GG.load_path(x, w)} loads; K4t with f32 and "
          f"bf16 dy, {GG.load_path(dyb, w)} loads; K5 "
          f"{GG.load_path(x, dy.to(torch.bfloat16))} loads, chunks of {GG.TGMM_CHUNK_ROWS} rows, "
          f"{'a reduction over ' + str(slots) + ' workspace slots' if slots else 'no reduction'}"
          f", two launches bit-identical; " + ", ".join(
              f"{n} max|err| {errs[n]:.3e} rel L2 {rels[n]:.2e}" for n in errs)
          + f" (rtol {GMM_RTOL}, atol {GMM_ATOL}, rel L2 {GMM_REL_L2}; wrapper and NaN-filled "
          f"output)", flush=True)
    return errs


# K4's widths in tests/test_torch_dispatch.py (GMM_CASES): boundaries inside
# tiles with empty groups, one group of 8, E = 1, E = 64, empty first and
# last groups, rows past the last group, the decode shape, widths of 100 and
# 37 (cp.async) and an odd contraction.
GMM_CASES = [
    (256, 128, 256, [0, 70, 0, 3, 97, 86, 0]),
    (300, 64, 192, [0, 0, 0, 300, 0, 0, 0, 0]),
    (384, 192, 320, [384]),
    (1024, 128, 136, [0] + [16] * 60 + [24, 0, 40]),
    (640, 128, 256, [0, 200, 150, 290, 0]),
    (300, 128, 128, [17, 0, 200, 33]),
    (128, 2048, 2752, [5, 9, 0, 2, 7, 1, 0, 104]),
    (300, 100, 100, [17, 0, 250, 33]),
    (200, 99, 37, [60, 0, 90, 20]),
]


def check_transposed_widths() -> float:
    """K4t alone at the GMM_CASES widths with an f32 and a bf16 dy, into
    outputs filled with NaN, against its plain version; an f32 dy gives the
    bits of the same dy rounded to bf16 by hand.  Returns the largest max
    |err|."""
    import torch
    from unimoe_audio_torch.ops import grouped_gemm as GG

    worst = 0.0
    for i, (A, K, N, sizes) in enumerate(GMM_CASES):
        gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
        _, w, dy = grouped_operands(A, K, N, len(sizes), 60 + i)
        outs = {}
        for dt in (torch.float32, torch.bfloat16):
            outs[dt] = torch.full((A, K), float("nan"), dtype=torch.bfloat16, device="cuda")
            GG.launch_gmm(dy.to(dt), w, gs, outs[dt], True)
        torch.cuda.synchronize()
        want = GG.gmm_reference(dy, w, gs, transpose_rhs=True).float()
        for dt, out in outs.items():
            o = out.float()
            err = (o - want).abs()
            rel = ((o - want).norm() / want.norm().clamp_min(1e-30)).item()
            check(bool(torch.isfinite(o).all()) and bool((err <= GMM_ATOL + GMM_RTOL * want.abs()).all())
                  and rel <= GMM_REL_L2, f"K4t A={A} K={K} N={N} {dt}: max err {err.max().item()}, "
                  f"relative L2 {rel}")
            worst = max(worst, err.max().item())
        check(torch.equal(outs[torch.float32], outs[torch.bfloat16]),
              f"K4t A={A} K={K} N={N}: an f32 dy and the same dy rounded to bf16 differ")
    print(f"kernel check: K4t at {len(GMM_CASES)} widths (N of 100 and 37 through cp.async), "
          f"f32 and bf16 dy into NaN-filled outputs: max|err| {worst:.3e} (rtol {GMM_RTOL}, atol "
          f"{GMM_ATOL}, rel L2 {GMM_REL_L2}); f32 dy bit-identical to dy rounded by hand", flush=True)
    return worst


def check_grouped_all() -> dict:
    """The grouped GEMMs at the training, prefill and decode shapes of the
    flagship (group sizes from its router), then the edge cases.  Returns
    the largest max |err| of each kernel over all cases."""
    import torch
    from unimoe_audio_torch.config import TextMoEConfig
    from unimoe_audio_torch.moe.dispatch import gmm_group_sizes

    tc = TextMoEConfig()
    D, Fd = tc.hidden_size, tc.dynamic_intermediate_size
    errs = []
    gs, A = flagship_group_sizes(TRAIN_B * TRAIN_T, seed=30)
    errs.append(check_grouped("training gate/up", A, D, Fd, gs, seed=31))
    errs.append(check_grouped("training down", A, Fd, D, gs, seed=32))
    gs, A = flagship_group_sizes(8 * 128, seed=33)
    errs.append(check_grouped("T2M prefill", A, D, Fd, gs, seed=34))
    gs, A = flagship_group_sizes(8, seed=35)
    errs.append(check_grouped("T2M decode", A, D, Fd, gs, seed=36))
    # Empty first, middle and last groups, a group of 3 rows, boundaries
    # inside 128-row tiles.
    errs.append(check_grouped("empty groups", 256, 256, 384, [0, 70, 0, 3, 97, 86, 0, 0],
                              seed=37))
    # A budget of 128 rows below S x E = 256 selected slots: [64, 64, 0, 0].
    budget = gmm_group_sizes(torch.ones(64, 4, dtype=torch.int32, device="cuda"), 128)
    errs.append(check_grouped("budget below S x E", 128, 256, 384, budget, seed=38))
    # Widths of 100 (rows not a multiple of 16 bytes: cp.async) and 50 rows
    # past the last group; odd widths.
    errs.append(check_grouped("width 100", 300, 100, 100, [17, 0, 200, 33], seed=39))
    errs.append(check_grouped("odd widths", 200, 99, 37, [60, 0, 90, 20], seed=40))
    # All rows in one group of 8; E = 1 over two K5 chunks; E = 64; a group
    # split over three K5 chunks beside groups that are not.
    errs.append(check_grouped("one group of 8", 512, 256, 384, [0, 0, 0, 512, 0, 0, 0, 0],
                              seed=41))
    errs.append(check_grouped("E = 1", 5000, 128, 256, [5000], seed=42))
    errs.append(check_grouped("E = 64", 2048, 128, 256, [0] + [30] * 62 + [188], seed=43))
    errs.append(check_grouped("split group", 9000, 128, 256, [0, 10, 8500, 0, 490, 0],
                              seed=44))
    worst = {k: max(e[k] for e in errs) for k in errs[0]}
    worst["grouped_gemm_gmm_transposed"] = max(worst["grouped_gemm_gmm_transposed"],
                                               check_transposed_widths())
    return worst


def generate_dispatch(model, prompts, dispatch_mode: str, max_tokens: int, min_tokens: int,
                      seed: int, **kw):
    """`generate_chunked` on the model's parameters and the CFG-paired
    prompts, with the knobs `text_to_music` uses (and `kw`, such as the
    serving dispatch); returns the result and the device-synchronised
    timings."""
    import torch
    from unimoe_audio_torch.codec import delay as dl
    from unimoe_audio_torch.generate.loop import generate_chunked, pad_buffer

    cfg = model.config
    ids, mask = model._tokenize(prompts)
    prefill, steps = dl.prepare_audio_prompt(
        [None] * (len(prompts) // 2), num_channels=cfg.codec_channels,
        bos_value=cfg.codec_bos_value, delay_pattern=cfg.codec_delay_pattern)
    buf = pad_buffer(torch.as_tensor(prefill, device="cuda"), max_tokens)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    timings: dict = {}
    with torch.inference_mode():
        res = generate_chunked(
            model.params, cfg, torch.as_tensor(ids, device="cuda"),
            torch.as_tensor(mask, device="cuda"), None, buf, steps, gen,
            max_tokens=max_tokens, min_tokens=min_tokens, cfg_scale=10.0, temperature=1.0,
            top_p=1.0, cfg_filter_top_k=45, eos_prob_mul_factor=0.6, timings=timings,
            dispatch_mode=dispatch_mode, **kw)
    return res, timings


def profile_decode(model, prompts, dispatch_mode: str, **kw) -> dict:
    """READS_FRAMES decode steps under torch.profiler, after the prefill and
    a first step run outside it (`generate` paused and resumed): per decode
    step the device-to-host reads (`aten::_local_scalar_dense`, the host
    blocking on a device value), the decode's ms, the device kernel time
    and the launches; and the kernels and host operators that take the
    most time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from unimoe_audio_torch.codec import delay as dl
    from unimoe_audio_torch.generate.loop import generate, pad_buffer

    cfg = model.config
    ids, mask = model._tokenize(prompts)
    prefill, steps = dl.prepare_audio_prompt(
        [None] * (len(prompts) // 2), num_channels=cfg.codec_channels,
        bos_value=cfg.codec_bos_value, delay_pattern=cfg.codec_delay_pattern)
    n = READS_FRAMES + 1
    args = (model.params, cfg, torch.as_tensor(ids, device="cuda"),
            torch.as_tensor(mask, device="cuda"), None,
            pad_buffer(torch.as_tensor(prefill, device="cuda"), n), steps,
            torch.Generator(device="cuda").manual_seed(4))
    knobs = dict(max_tokens=n, min_tokens=n, cfg_scale=10.0, temperature=1.0, top_p=1.0,
                 cfg_filter_top_k=45, eos_prob_mul_factor=0.6, dispatch_mode=dispatch_mode,
                 return_state=True, **kw)
    t: dict = {}
    with torch.inference_mode():
        _, state = generate(*args, stop_at=int(np.min(steps)), **knobs)   # prefill, 1 step
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            res, _ = generate(*args, resume_state=state, timings=t, **knobs)
    n_steps = res.steps - 1
    ev = prof.key_averages()
    kernels = [e for e in ev if e.device_type == torch.autograd.DeviceType.CUDA]
    host = [e for e in ev if e.device_type != torch.autograd.DeviceType.CUDA]
    return {
        "reads": sum(e.count for e in ev if e.key == "aten::_local_scalar_dense") / n_steps,
        "decode_ms": t["decode_s"] * 1e3 / n_steps,
        "device_ms": sum(e.self_device_time_total for e in kernels) / 1e3 / n_steps,
        "launches": sum(e.count for e in kernels) / n_steps,
        "top_kernels": [(e.key[:50], round(e.self_device_time_total / 1e3, 2), e.count)
                        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:4]],
        "top_host": [(e.key[:50], round(e.self_cpu_time_total / 1e3, 2), e.count)
                     for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:6]],
    }


def vt2m_videos(names=tuple(VT2M_VIDEOS)) -> list:
    """The VT2M_VIDEOS frames, made from seed 0 in a fixed order (so a
    subset holds the same arrays)."""
    rng = np.random.default_rng(0)
    made = {k: rng.uniform(0, 255, size=s).astype(np.float32) for k, s in VT2M_VIDEOS.items()}
    return [made[n] for n in names]


@contextlib.contextmanager
def _tower_calls():
    """Records (grid, feature shape) of every `vision_forward` call made
    while the block runs (the API calls it through its module)."""
    from unimoe_audio_torch.models import vision as V

    calls = []
    forward = V.vision_forward

    def counted(params, patches, grid_thw, cfg):
        out = forward(params, patches, grid_thw, cfg)
        calls.append((tuple(int(x) for x in np.asarray(grid_thw).reshape(-1)), tuple(out.shape)))
        return out

    V.vision_forward = counted
    try:
        yield calls
    finally:
        V.vision_forward = forward


def _capture_core(model, captured: dict) -> None:
    """Wraps model._generate_core so that its token ids, mask, codec rows
    and keyword arguments (the vision inputs) land in `captured`; `del
    model._generate_core` undoes it."""
    core = model._generate_core

    def capture(ids, mask, codec, *a, **k):
        captured.update(ids=ids, mask=mask, codec=codec, **k)
        return core(ids, mask, codec, *a, **k)

    model._generate_core = capture


def _check_vt2m_run(model, names, paths, calls, captured, launches, label: str) -> None:
    """The checks of one video_text_to_music call on the card: one K1 launch
    per layer (one prefill) and no backward or grouped launch; one tower call
    per video with features [tokens, out_hidden]; each CFG row's video slots
    equal its video's tokens; rope_deltas < 0 in every row; the t, h and w
    position rows differ; one wav per request of frames x hop samples, codes
    in range, not silent."""
    cfg = model.config
    tc, vcfg = cfg.text_config, cfg.vision_config
    check(launches["flash_attention_fwd"] == tc.num_hidden_layers,
          f"{label}: {launches['flash_attention_fwd']} K1 launches, want "
          f"{tc.num_hidden_layers} (one per layer in the one prefill)")
    check(all(n == 0 for k, n in launches.items() if k != "flash_attention_fwd"),
          f"{label} launched a backward or grouped kernel: {launches}")
    tokens = [VT2M_TOKENS[n] for n in names]
    check([shape for _, shape in calls] == [(n, vcfg.out_hidden_size) for n in tokens],
          f"{label}: tower calls (grid, features) {calls}, want one per video of {tokens} tokens")
    vmask = np.asarray(captured["visual_mask"])
    check(vmask.sum(-1).tolist() == [n for n in tokens for _ in range(2)],
          f"{label}: video slots per row {vmask.sum(-1).tolist()}, want {tokens} per CFG pair")
    deltas = np.asarray(captured["rope_deltas"]).reshape(-1)
    check(bool((deltas < 0).all()), f"{label}: rope_deltas {deltas.tolist()} not all negative")
    pos = np.asarray(captured["prefill_position_ids"])
    check(not np.array_equal(pos[0], pos[1]) and not np.array_equal(pos[1], pos[2]),
          f"{label}: the t, h and w position rows do not differ")
    t = model.last_timings
    hop, sr = model.dac.config.hop_length, model.dac.config.sample_rate
    check(len(paths) == len(names), f"{label}: {len(paths)} wavs for {len(names)} requests")
    for p, n, c in zip(paths, t["lengths"], model.last_codes):
        check(os.path.isfile(p), f"missing wav {p}")
        check(n > 0 and c.shape == (n, cfg.codec_channels), f"{label}: {n} frames, codes {c.shape}")
        check(bool((c >= 0).all() and (c < model.dac.config.codebook_size).all()),
              f"{label}: codes out of range")
        with wave.open(p) as f:
            pcm = np.frombuffer(f.readframes(f.getnframes()), "<i2")
        check(pcm.size == max(n * hop, sr) and int(np.abs(pcm[:n * hop]).max()) > 0,
              f"{p}: {pcm.size} samples for {n} frames, or silent")


def run_vt2m(model, card: str, out_dir: str):
    """Video+text-to-music through `UniMoEAudio.video_text_to_music` on the
    flagship with its full vision tower: the four VT2M_VIDEOS with their
    captions, the tower once per video, the features scattered at the
    video slots of both rows of each CFG pair, 3-D mRoPE positions, the
    prefill through K1, decode from T_text + rope_deltas, the wavs.  Then
    the tower timed per video, K1 at this prefill's shape, and the two
    reference checks against the CPU.  Returns (launch counts, K1's record
    at this shape)."""
    import torch
    from unimoe_audio_torch.apps.video import video_to_patches
    from unimoe_audio_torch.models import vision as V

    cfg = model.config
    tc, vcfg = cfg.text_config, cfg.vision_config
    names = list(VT2M_VIDEOS)
    videos = vt2m_videos(names)
    captions = [caption(n) for n in VT2M_CAPTION_WORDS]
    kw = dict(output_dir=out_dir, cfg_scale=10.0)
    model.video_text_to_music(videos, captions, save_name="vt2m_warmup", seed=1,
                              max_audio_seconds=1, min_audio_seconds=0.5, **kw)
    captured: dict = {}
    _capture_core(model, captured)
    _zero_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with _tower_calls() as calls:
            paths = model.video_text_to_music(videos, captions, save_name="vt2m", seed=0,
                                              max_audio_seconds=VT2M_SECONDS,
                                              min_audio_seconds=VT2M_MIN_SECONDS, **kw)
    finally:
        del model._generate_core
    wall_s = time.perf_counter() - t0
    launches = _launch_counts()
    _check_vt2m_run(model, names, paths, calls, captured, launches, "VT2M")
    t = model.last_timings
    ids, mask = captured["ids"], captured["mask"]
    deltas = np.asarray(captured["rope_deltas"]).reshape(-1)
    print(f"vt2m [{card}]: {len(names)} videos {', '.join(f'{n} {VT2M_VIDEOS[n]} grid {g}' for n, (g, _) in zip(names, calls))} "
          f"-> video tokens {[s[0] for _, s in calls]}; 8 CFG rows, T_text {t['T_text']}, "
          f"left pads {[int((m == 0).sum()) for m in mask]}, rope_deltas {deltas.tolist()}; "
          f"{t['steps']} decode steps, frames {t['lengths']}; flash launches "
          f"{launches['flash_attention_fwd']}", flush=True)

    tower_ms = []
    with torch.inference_mode():
        for v in videos:
            patches, grid = video_to_patches(v, patch_size=vcfg.patch_size,
                                             temporal_patch_size=vcfg.temporal_patch_size,
                                             merge_size=vcfg.spatial_merge_size)
            pt = torch.as_tensor(patches, device="cuda")
            tower_ms.append(cuda_ms(
                lambda: V.vision_forward(model.params["vision"], pt, grid[None], vcfg),
                iters=5, warmup=1))
    audio_s = sum(t["lengths"]) / 50.0
    gen_s = sum(t["vision_s"]) + t["prefill_s"] + t["decode_s"] + t["dac_s"]
    print(f"vt2m [{card}]: tower ({vcfg.depth} blocks, hidden {vcfg.hidden_size}, bf16) ms per "
          f"video by CUDA events {', '.join(f'{n} {x:.2f}' for n, x in zip(names, tower_ms))} "
          f"(in the call, host-synchronised: "
          f"{', '.join(f'{x * 1e3:.2f}' for x in t['vision_s'])}); prefill "
          f"{t['prefill_s'] * 1e3:.2f} ms; decode {t['decode_s'] * 1e3 / t['steps']:.2f} ms/frame; "
          f"DAC {t['dac_s'] * 1e3:.1f} ms; realtime factor {audio_s / gen_s:.3f} ({audio_s:.2f} s "
          f"of audio in {gen_s:.2f} s, first tower call to DAC decode; {wall_s:.2f} s wall for "
          f"the whole call)", flush=True)
    rec = time_flash(tc, mask, launches, card, "VT2M")
    check_vt2m_reference(cfg, captured, card)
    return launches, rec


@contextlib.contextmanager
def router_tape(tape: list, replay: list | None = None):
    """Taps the DCMoE router's eval-path decisions, in call order (one call
    a layer): each call's [router logits, top-p counts] (CPU copies) go to
    `tape`.  With `replay` (another run's tape, same call order), each call
    takes the replayed counts and decides its mixer (experts, near-sets,
    weights) from the replayed logits, so that both runs route every token
    alike; its own logits are still taped."""
    from unimoe_audio_torch.moe import router as R

    select, mixer = R.dynamic_expert_selection, R.sparse_expert_mixer_eval

    def replaying():
        # Past the replayed run's last call (a run that goes on longer) each
        # call routes on its own.
        return replay is not None and len(tape) <= len(replay)

    def tapped_select(logits, top_p):
        k = select(logits, top_p)
        tape.append([logits.float().cpu(), k.cpu()])
        return replay[len(tape) - 1][1].to(k.device) if replaying() else k

    def tapped_mixer(scores, top_k, *, jitter_eps):
        if replaying():
            scores = replay[len(tape) - 1][0].to(scores.device, scores.dtype)
        return mixer(scores, top_k, jitter_eps=jitter_eps)

    R.dynamic_expert_selection, R.sparse_expert_mixer_eval = tapped_select, tapped_mixer
    try:
        yield tape
    finally:
        R.dynamic_expert_selection, R.sparse_expert_mixer_eval = select, mixer


def route_flips(tape_a: list, tape_b: list, tc) -> list:
    """Per tape entry (layer), a [S] bool: the tokens that b's own logits
    route otherwise than a's: another top-p count or expert set, or a
    routing weight that moves by more than ROUTE_WEIGHT_JUMP."""
    from unimoe_audio_torch.moe import router as R

    out = []
    for (la, ka), (lb, kb) in zip(tape_a, tape_b):
        (wa, ma), (wb, mb) = (R.sparse_expert_mixer_eval(x, k, jitter_eps=tc.router_jitter_noise)
                              for x, k in ((la, ka), (lb, kb)))
        out.append((ka != kb) | (ma != mb).any(-1)
                   | ((wa - wb).abs() > ROUTE_WEIGHT_JUMP).any(-1))
    return out


def replay_report(card_tape: list, cpu_tape: list, tc, live=None) -> tuple:
    """(router logits relative L2, route flips by call) of a CPU run that
    replayed the card's tape: the largest relative L2 of the two runs'
    router logits over a call's rows, and per call the count of rows that
    the CPU's own logits would route otherwise (`route_flips`).  live, a
    [S] bool, restricts the calls of S rows (a prefill's) to live tokens."""
    check(len(card_tape) == len(cpu_tape),
          f"router tapes of {len(card_tape)} and {len(cpu_tape)} calls")
    err, flips = 0.0, []
    for (a, _), (b, _), f in zip(card_tape, cpu_tape, route_flips(card_tape, cpu_tape, tc)):
        rows = live if live is not None and len(live) == len(a) else slice(None)
        err = max(err, _rel(a[rows], b[rows]))
        flips.append(int(f[rows].sum()))
    return err, flips


def check_vt2m_reference(flag_cfg, captured: dict, card: str) -> None:
    """Card vs CPU in f32, with the same (card-made) weights: the tower at
    full width cut to VT2M_REF_DEPTH blocks on video B (ragged windows;
    block 7 takes full attention), and a 2-layer flagship-width VT2M
    prefill fed by that tower on the CFG pairs of videos B and C from the
    VT2M batch (their ids, mask, video slots and mRoPE positions): features,
    and codec and router logits over live rows under the card's routing
    (`router_tape`), within VT2M_REF_REL_L2."""
    import dataclasses

    import torch
    from unimoe_audio_torch.apps.video import video_to_patches
    from unimoe_audio_torch.models import model as M
    from unimoe_audio_torch.models.layers import KVCache
    from unimoe_audio_torch.models.vision import init_vision_params, vision_forward

    vcfg = dataclasses.replace(flag_cfg.vision_config, depth=VT2M_REF_DEPTH)
    check(any(i < VT2M_REF_DEPTH for i in vcfg.fullatt_block_indexes),
          "the reference tower holds no full-attention block")
    tower = {"cuda": init_vision_params(vcfg, seed=5, dtype=torch.float32, device="cuda")}
    tower["cpu"] = _to(tower["cuda"], device="cpu")
    vids = dict(zip(VT2M_VIDEOS, vt2m_videos()))
    feats = {}
    with torch.inference_mode():
        for name in ("B", "C"):
            patches, grid = video_to_patches(vids[name])
            feats[name] = {dev: vision_forward(p, torch.as_tensor(patches, device=dev), grid[None],
                                               vcfg).float().cpu()
                           for dev, p in tower.items()}
    err = _rel(feats["B"]["cuda"], feats["B"]["cpu"])
    print(f"reference check [{card}]: vision tower at full width, {VT2M_REF_DEPTH} blocks "
          f"(full attention in {[i for i in vcfg.fullatt_block_indexes if i < VT2M_REF_DEPTH]}), "
          f"f32, video B ({tuple(feats['B']['cpu'].shape)} features), card vs CPU: relative L2 "
          f"{err:.3e} (limit {VT2M_REF_REL_L2})", flush=True)
    check(err < VT2M_REF_REL_L2, f"vision tower, card vs CPU: relative L2 {err}")

    cfg = dataclasses.replace(flag_cfg, text_config=dataclasses.replace(
        flag_cfg.text_config, num_hidden_layers=2))
    tc = cfg.text_config
    gpu = M.init_model_params(cfg, seed=3, dtype=torch.float32, device="cuda")
    cpu = _to(gpu, device="cpu")
    rows = slice(2, 6)                                  # the CFG pairs of videos B and C
    ids, mask = captured["ids"][rows], captured["mask"][rows]
    vmask = np.asarray(captured["visual_mask"])[rows]
    pos = np.asarray(captured["prefill_position_ids"])[:, rows]
    B, T = ids.shape
    live = torch.as_tensor(mask, dtype=torch.bool)

    def run(device, replay=None):
        params = cpu if device == "cpu" else gpu
        t = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=device)   # noqa: E731
        emb = M.calculate_input_embedding(params, t(ids), None, cfg.codec_placeholder_value)
        visual = torch.zeros_like(emb)
        for r, name in enumerate("BBCC"):
            visual[r, t(np.flatnonzero(vmask[r]))] = feats[name][device].to(device)
        emb = torch.where(t(vmask)[..., None] > 0, visual, emb)
        cache = KVCache.create(tc.num_hidden_layers, B, T + 2, tc.num_key_value_heads,
                               tc.head_dim, dtype=torch.float32, device=device)
        kv_valid = np.concatenate([mask, np.zeros((B, 2), mask.dtype)], -1)
        tape: list = []
        with router_tape(tape, replay):
            out = M.text_model_forward(params, emb, t(pos), tc, kv_cache=cache, cache_position=0,
                                       kv_valid_mask=t(kv_valid, torch.int32),
                                       padding_token_mask=t(mask, torch.int32))
        return M.codec_logits_from_hidden(params, out.last_hidden_state, cfg).cpu()[live], tape

    with torch.inference_mode():
        got, card_tape = run("cuda")
        want, cpu_tape = run("cpu", replay=card_tape)
    err = _rel(got, want)
    rows = live.reshape(-1)
    router_err = max(_rel(a[rows], b[rows]) for (a, _), (b, _) in zip(card_tape, cpu_tape))
    flips = [int(f[rows].sum()) for f in route_flips(card_tape, cpu_tape, tc)]
    print(f"reference check [{card}]: 2-layer flagship-width VT2M prefill, f32, fed by the "
          f"{VT2M_REF_DEPTH}-block tower, the CFG pairs of videos B and C (T {T}, "
          f"{int(vmask.sum())} video slots, 3-D mRoPE positions; ids crc32 "
          f"{zlib.crc32(np.ascontiguousarray(ids, np.int64).tobytes()):08x}, PYTHONHASHSEED "
          f"{os.environ.get('PYTHONHASHSEED', 'random')}), card vs CPU under the card's routing: "
          f"codec logits relative L2 {err:.3e}, router logits {router_err:.3e} (limit "
          f"{VT2M_REF_REL_L2} each); live tokens the CPU's own router logits would route "
          f"otherwise, by layer: {flips} of {int(rows.sum())}", flush=True)
    check(err < VT2M_REF_REL_L2 and router_err < VT2M_REF_REL_L2,
          f"VT2M prefill, card vs CPU: relative L2 {err} (router logits {router_err})")
    del gpu, cpu, tower
    torch.cuda.empty_cache()


def run_vt2m_int8(model, card: str, out_dir: str) -> dict:
    """One short video_text_to_music call of the int8 serving model, whose
    tower `quantize_vision_params` made int8: videos VT2M_INT8_VIDEOS with
    their captions, VT2M_INT8_SECONDS.  The checks of the bf16 VT2M run.
    Returns its launch counts."""
    import torch
    from unimoe_audio_torch.ops.quant import QTensor

    vis = model.params["vision"]
    check(all(isinstance(w, QTensor) and w.q.dtype == torch.int8 for w in (
        vis["patch_embed"], vis["blocks"][0]["qkv"]["w"], vis["blocks"][-1]["mlp"]["down"]["w"],
        vis["merger"]["fc2"]["w"])), "int8 serving: the vision tower is not int8")
    names = list(VT2M_INT8_VIDEOS)
    captions = [caption(VT2M_CAPTION_WORDS[list(VT2M_VIDEOS).index(n)]) for n in names]
    captured: dict = {}
    _capture_core(model, captured)
    _zero_launch_counts()
    try:
        with _tower_calls() as calls:
            paths = model.video_text_to_music(
                vt2m_videos(names), captions, save_name="vt2m_int8", seed=0, output_dir=out_dir,
                max_audio_seconds=VT2M_INT8_SECONDS, min_audio_seconds=VT2M_INT8_SECONDS / 2)
    finally:
        del model._generate_core
    launches = _launch_counts()
    _check_vt2m_run(model, names, paths, calls, captured, launches, "VT2M int8")
    t = model.last_timings
    print(f"vt2m_int8 [{card}]: serving_mode={model.serving_mode!r}, int8 tower; videos "
          f"{names}, T_text {t['T_text']}, frames {t['lengths']}; tower ms in the call "
          f"{[round(x * 1e3, 2) for x in t['vision_s']]}; prefill {t['prefill_s'] * 1e3:.2f} ms; "
          f"decode {t['decode_s'] * 1e3 / t['steps']:.2f} ms/frame; flash launches "
          f"{launches['flash_attention_fwd']}", flush=True)
    return launches


def _equal_frame_share(pairs, max_delay: int) -> float:
    """Share of equal codec frames over (codes_a, len_a, codes_b, len_b)
    pairs of delayed-domain codes [T, C], each compared up to its longer
    span (frames + max_delay)."""
    equal = total = 0
    for a, la, b, lb in pairs:
        n = min(max(la, lb) + max_delay, len(a), len(b))
        equal += int(np.all(a[:n] == b[:n], axis=-1).sum())
        total += n
    return equal / max(total, 1)


def _check_wavs(paths, lengths, hop: int, sr: int, label: str) -> None:
    """Each wav exists and holds max(frames x hop, 1 s) samples of not
    silent audio."""
    for p, n in zip(paths, lengths):
        check(os.path.isfile(p), f"{label}: missing wav {p}")
        with wave.open(p) as f:
            pcm = np.frombuffer(f.readframes(f.getnframes()), "<i2")
        check(n > 0 and pcm.size == max(n * hop, sr) and int(np.abs(pcm[:n * hop]).max()) > 0,
              f"{label}: {p}: {pcm.size} samples for {n} frames, or silent")


def _alone_shares(model, reqs, batch_codes, out_dir: str, label: str) -> list:
    """Each request run alone through generate_mixed with its seed: the
    share of its frames that equal its stream of the batch."""
    shares = []
    for i, r in enumerate(reqs):
        model.generate_mixed([r], output_dir=out_dir, save_name=f"{label}_alone_{i}")
        alone = model.last_codes[0]
        shares.append(_equal_frame_share([(alone, len(alone), batch_codes[i],
                                           len(batch_codes[i]))], 0))
    return shares


@contextlib.contextmanager
def first_decode_logits():
    """Records the codec logits of the first decode step of the first
    `generate` call made while the block runs ([2B, C, Vc] f32 on the CPU;
    the loop computes them through its module's `codec_logits_from_hidden`,
    which the prefill does not call)."""
    from unimoe_audio_torch.generate import loop as LP

    out, f = [], LP.codec_logits_from_hidden

    def recorded(params, hidden, cfg):
        y = f(params, hidden, cfg)
        if not out:
            out.append(y[:, 0].float().cpu())
        return y

    LP.codec_logits_from_hidden = recorded
    try:
        yield out
    finally:
        LP.codec_logits_from_hidden = f


def _first_request_drift(batch_logits, alone_logits) -> float:
    """Relative L2 of the first request's CFG pair of codec logits (rows 0
    and 1) alone against in the batch."""
    a, b = alone_logits[0][:2], batch_logits[0][:2]
    return ((a - b).norm() / b.norm()).item()


def run_mixed_batch(model, wav: str, card: str, out_dir: str):
    """One `generate_mixed` batch of MIXED_T2M, a TTS and a VT2M request,
    sampled with a seed each: every stream within its budget, one prefill
    (36 K1 launches) and no other kernel; then the first request alone with
    its seed, the share of its frames that equal its row of the batch, and
    again at the batch's T_text (not gated: bf16 products over other
    shapes round differently; the f32 witness is in
    `check_serving_reference`).  Returns (launch counts, the two shares)."""
    import torch

    tc = model.config.text_config
    reqs = [{"task": "text_to_music", "caption": caption(w), "cfg_scale": c, "seed": 100 + i,
             "max_audio_seconds": s, "min_audio_seconds": 0.5}
            for i, (c, s, w) in enumerate(MIXED_T2M)]
    reqs += [{"task": "text_to_speech", "caption": TTS_SENTENCES[1], "prompt_text": TTS_PROMPT_TEXT,
              "prompt_wav": wav, "seed": 102, "max_audio_seconds": MIXED_TTS_SECONDS,
              "min_audio_seconds": 0.5},
             {"task": "video_text_to_music", "caption": caption(40), "video": vt2m_videos(("C",))[0],
              "seed": 103, "max_audio_seconds": MIXED_VT2M_SECONDS, "min_audio_seconds": 0.5}]
    budgets = [int(r["max_audio_seconds"] * 50) for r in reqs]
    _zero_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with first_decode_logits() as batch_logits:
        paths = model.generate_mixed(reqs, output_dir=out_dir, save_name="mixed")
    wall_s = time.perf_counter() - t0
    launches = _launch_counts()
    t, codes = model.last_timings, model.last_codes
    check(launches["flash_attention_fwd"] == tc.num_hidden_layers,
          f"mixed batch: {launches['flash_attention_fwd']} K1 launches, want "
          f"{tc.num_hidden_layers} (one prefill)")
    check(all(n == 0 for k, n in launches.items() if k != "flash_attention_fwd"),
          f"mixed batch launched a backward or grouped kernel: {launches}")
    check(len(paths) == len(reqs), f"mixed batch: {len(paths)} wavs for {len(reqs)} requests")
    check(all(0 < n <= b for n, b in zip(t["lengths"], budgets)),
          f"mixed batch: frames {t['lengths']} against budgets {budgets}")
    _check_wavs(paths, t["lengths"], model.dac.config.hop_length, model.dac.config.sample_rate,
                "mixed batch")
    audio_s = sum(t["lengths"]) / 50.0
    print(f"serving [{card}]: mixed batch T2M x2 (cfg 10 / 5) + TTS + VT2M, sampled, seeds "
          f"100-103: T_text {t['T_text']}, {t['steps']} decode steps, frames {t['lengths']} "
          f"(budgets {budgets}); K1 launches {launches['flash_attention_fwd']}; tower "
          f"{sum(t['vision_s']) * 1e3:.2f} ms, prefill {t['prefill_s'] * 1e3:.2f} ms, decode "
          f"{t['decode_s']:.3f} s ({t['decode_s'] * 1e3 / t['steps']:.2f} ms/frame), DAC "
          f"{t['dac_s'] * 1e3:.1f} ms; aggregate realtime factor {audio_s / wall_s:.3f} "
          f"({audio_s:.2f} s of audio in {wall_s:.2f} s, the whole call with the prompt's "
          f"DAC encode)", flush=True)
    with first_decode_logits() as alone_logits:
        share = _alone_shares(model, reqs[:1], codes, out_dir, "mixed")[0]
    alone_T, alone_n = model.last_timings["T_text"], len(model.last_codes[0])
    # The same request alone at the batch's bucket: its CFG pair left-padded
    # to the batch's T_text as the batch pads it, so that only the row count
    # differs from its rows of the batch.
    r = reqs[0]
    ids, mask = model._tokenize(_t2m_prompts([r["caption"]]))
    pad = ((0, 0), (t["T_text"] - ids.shape[1], 0))
    with first_decode_logits() as bucket_logits:
        model._generate_core(
            np.pad(ids, pad), np.pad(mask, pad), None, "mixed_alone_bucket", None, out_dir,
            cfg_scale=r["cfg_scale"], eos_prob_mul_factor=0.6, max_tokens=budgets[0],
            min_tokens=int(r["min_audio_seconds"] * 50), max_tokens_vec=[budgets[0]],
            sample_seeds=[r["seed"]])
    at_bucket = model.last_codes[0]
    bucket_share = _equal_frame_share([(at_bucket, len(at_bucket), codes[0], len(codes[0]))], 0)
    drift = (_first_request_drift(batch_logits, alone_logits),
             _first_request_drift(batch_logits, bucket_logits))
    print(f"serving [{card}]: the first request alone with its seed: at T_text {alone_T}, "
          f"{alone_n} frames against {len(codes[0])} in the batch, equal frames {share:.3f}; "
          f"at the batch's T_text {t['T_text']} (2 rows instead of 8), {len(at_bucket)} "
          f"frames, equal frames {bucket_share:.3f} (neither gated)", flush=True)
    print(f"serving [{card}]: bf16 drift with the batch's shape: codec logits of the first "
          f"request's CFG pair at its first decode step, relative L2 alone vs in the batch: "
          f"{drift[0]:.3e} at T_text {alone_T}, {drift[1]:.3e} at the batch's T_text "
          f"{t['T_text']} (a measurement, not gated)", flush=True)
    return launches, (share, bucket_share, *drift)


def _slot_standalone(params, cfg, req, t_text: int):
    """A SlotRequest decoded alone by `generate` on the card, its ids and
    vision inputs right-padded to t_text as the server pads them."""
    import torch
    from unimoe_audio_torch.generate.loop import generate, pad_buffer
    from unimoe_audio_torch.models.model import align_codec_ids

    t_req = req.input_ids.shape[1]

    def pad(a):
        a = np.asarray(a)
        return np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, t_text - t_req)])

    ids, mask = pad(req.input_ids), pad(req.attention_mask)
    kw = {}
    if req.visual_embeds is not None:
        ve = torch.zeros(2, t_text, req.visual_embeds.shape[-1], dtype=req.visual_embeds.dtype,
                         device="cuda")
        ve[:, :t_req] = req.visual_embeds
        kw = dict(visual_embeds=ve, visual_mask=torch.as_tensor(pad(req.visual_mask), device="cuda"),
                  prefill_position_ids=torch.as_tensor(pad(req.prefill_position_ids), device="cuda"),
                  rope_deltas=torch.as_tensor(np.asarray(req.rope_deltas).reshape(-1),
                                              device="cuda"))
    codec = None
    if req.codec_flat is not None:
        codec = torch.as_tensor(align_codec_ids(ids, np.tile(req.codec_flat, (2, 1)),
                                                cfg.codec_placeholder_value), device="cuda")
    res = generate(
        params, cfg, torch.as_tensor(ids, device="cuda"), torch.as_tensor(mask, device="cuda"),
        codec, pad_buffer(torch.as_tensor(req.prefill[None], device="cuda"), req.max_tokens),
        [req.prefill_steps], torch.Generator(device="cuda"), max_tokens=req.max_tokens,
        min_tokens=req.min_tokens, cfg_scale=req.cfg_scale, temperature=req.temperature,
        top_p=req.top_p, cfg_filter_top_k=45, eos_prob_mul_factor=req.eos_prob_mul_factor,
        sample_seeds=[req.seed], do_sample=False, **kw)
    return res.codes[0].cpu().numpy(), int(res.lengths[0])


def _serve_schedule(server, first, late, chunk_ms=None):
    """Submit `first`, run one chunk, submit `late`, run until drained;
    returns the results by rid (each chunk's host-synchronised ms into
    chunk_ms)."""
    import torch

    def step():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = server.step()
        torch.cuda.synchronize()
        if chunk_ms is not None:
            chunk_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    for r in first:
        server.submit(r)
    results = step()
    for r in late:
        server.submit(r)
    while server.queue or server.active.any():
        results += step()
    return {r.rid: r for r in results}


def _late_tts_seconds(first, max_delay: int, horizon: int, chunk: int) -> float:
    """The late TTS request's budget on the continuous schedule (SERVE_*
    above): it does not fit the horizon when the second T2M row retires (3
    chunks in), but fits once the rows of 4 chunks have retired and the
    server has compacted the 2 chunks below the VT2M row.  In seconds, half
    a frame over, so that the request's frame count comes out exact."""
    extra = first.prefill.shape[0] + max_delay + 2
    return (horizon + 2 - 5 * chunk // 2 - extra + 0.5) / 50


def run_continuous(model, wav: str, card: str, out_dir: str):
    """The continuous slot server on the flagship (SERVE_* above): six
    greedy requests, two admitted mid-flight, one compaction; every
    request back within its budget, 36 K1 launches per admission.  Then K1
    at the admission shape (one request's CFG pair at t_text 256, its left
    pads from the tokenizer and its right pads from the server).  Returns
    (launch counts, K1's record at the admission shape)."""
    import torch

    cfg = model.config
    tc = cfg.text_config
    mk = model.make_slot_request
    first = [mk("t2m", caption=caption(w), seed=200 + i, max_audio_seconds=s, rid=f"t2m{i}")
             for i, (s, w) in enumerate(zip(SERVE_T2M_SECONDS, (58, 74, 90, 106)))]
    late = [mk("vt2m", caption=caption(40), video=vt2m_videos(("C",))[0], seed=204,
               max_audio_seconds=SERVE_VT2M_SECONDS, rid="vt2m"),
            mk("tts", caption=TTS_SENTENCES[2], prompt_text=TTS_PROMPT_TEXT, prompt_wav=wav,
               seed=205, rid="tts", max_audio_seconds=_late_tts_seconds(
                   first[0], cfg.max_delay, SERVE_HORIZON, SERVE_CHUNK))]
    budgets = {r.rid: r.max_tokens for r in first + late}
    server = model.continuous_server(slots=SERVE_SLOTS, t_text=SERVE_T_TEXT,
                                     horizon=SERVE_HORIZON, chunk_frames=SERVE_CHUNK,
                                     do_sample=False, deterministic=True)
    chunk_ms = []
    _zero_launch_counts()
    t0 = time.perf_counter()
    results = _serve_schedule(server, first, late, chunk_ms)
    wall_s = time.perf_counter() - t0
    launches = _launch_counts()
    admissions = len(budgets)
    check(set(results) == set(budgets), f"continuous: results {sorted(results)} for "
          f"{sorted(budgets)}")
    check(all(0 < results[k].length <= b for k, b in budgets.items()),
          f"continuous: lengths {[(k, results[k].length) for k in budgets]} against budgets "
          f"{budgets}")
    check(server.compactions >= 1, "continuous: no compaction")
    check(launches["flash_attention_fwd"] == tc.num_hidden_layers * admissions,
          f"continuous: {launches['flash_attention_fwd']} K1 launches, want "
          f"{tc.num_hidden_layers} x {admissions} admissions")
    check(all(n == 0 for k, n in launches.items() if k != "flash_attention_fwd"),
          f"continuous launched a backward or grouped kernel: {launches}")
    paths = model.decode_slot_results(list(results.values()), output_dir=out_dir,
                                      save_name="continuous")
    _check_wavs(paths, [r.length for r in results.values()], model.dac.config.hop_length,
                model.dac.config.sample_rate, "continuous")
    audio_s = sum(r.length for r in results.values()) / 50.0
    print(f"serving [{card}]: continuous server, {SERVE_SLOTS} slots, t_text {SERVE_T_TEXT}, "
          f"horizon {SERVE_HORIZON}, chunks of {SERVE_CHUNK}, greedy, dense: "
          f"{len(chunk_ms)} chunks, {server.compactions} compaction(s), K1 launches "
          f"{launches['flash_attention_fwd']} ({admissions} admissions); "
          + "; ".join(f"{k} {r.length}/{budgets[k]} frames, wait {r.wait_s:.3f} s, serve "
                      f"{r.serve_s:.3f} s" for k, r in results.items()), flush=True)
    print(f"serving [{card}]: continuous: {float(np.mean(chunk_ms)):.1f} ms per chunk (median "
          f"{float(np.median(chunk_ms)):.1f}, {SERVE_CHUNK} frames x {2 * SERVE_SLOTS} rows, "
          f"admissions included); aggregate realtime factor {audio_s / wall_s:.3f} "
          f"({audio_s:.2f} s of audio in {wall_s:.2f} s)", flush=True)
    mask = np.pad(first[0].attention_mask, ((0, 0), (0, SERVE_T_TEXT - first[0].input_ids.shape[1])))
    rec = time_flash(tc, mask, launches, card, "continuous admission")
    return launches, rec


def check_serving_reference(model, card: str, out_dir: str, flagship_shares) -> dict:
    """The serving apps on a 2-layer flagship-width f32 model on the card
    (weights from seed 3, the flagship's bf16 vision tower; SERVE_REF_*
    above), at the serving shapes, every prefill through the f32 K1.  First
    a mixed batch of the mixed phase's four tasks (T_text 256), sampled, a
    seed per request, against each request alone: the share of equal
    frames, printed beside the flagship's bf16 shares of the mixed phase,
    and the codec-logit drift of the first request at its first decode
    step.  Then the continuous schedule at half the scale and t_text 256,
    which must compact, against each request decoded alone by `generate`:
    lengths and the share of equal frames.  Then self-speculative decoding
    against the greedy baseline.  Each share at least
    SERVE_REF_EQUAL_SHARE.  Returns the launch counts of the three f32 runs
    (mixed_ref_f32: the batch; continuous_ref_f32: the server;
    speculative_ref_f32: the speculative call)."""
    import copy
    import dataclasses

    import torch
    from unimoe_audio_torch.apps.continuous import SlotServer
    from unimoe_audio_torch.models import model as M

    cfg = dataclasses.replace(model.config, text_config=dataclasses.replace(
        model.config.text_config, num_hidden_layers=2))
    L = cfg.text_config.num_hidden_layers
    params = M.init_model_params(cfg, seed=3, dtype=torch.float32, device="cuda")
    params["vision"] = model.params["vision"]     # the flagship's tower feeds the VT2M rows
    ref = copy.copy(model)
    ref.config, ref.params = cfg, params
    paths = {}

    def f32_prefills(launches, n, label):
        check(launches["flash_attention_fwd_f32"] == n * L
              and launches["flash_attention_fwd"] == 0,
              f"{label}: K1 launches {launches}, want {n} f32 prefill(s) of {L} layers")

    codec = np.random.default_rng(4).integers(0, cfg.codec_eos_value,
                                              size=(SERVE_REF_TTS_FRAMES, cfg.codec_channels))
    short = dict(min_audio_seconds=0.5, max_audio_seconds=0.8)
    reqs = [{"task": "text_to_music", "caption": caption(58), "cfg_scale": 10.0, "seed": 400,
             **short, "max_audio_seconds": 1.0},
            {"task": "text_to_music", "caption": caption(74), "cfg_scale": 5.0, "seed": 401,
             **short},
            {"task": "text_to_speech", "caption": TTS_SENTENCES[1], "prompt_text": TTS_PROMPT_TEXT,
             "prompt_codec": codec, "seed": 402, **short},
            {"task": "video_text_to_music", "caption": caption(40),
             "video": vt2m_videos(("C",))[0], "seed": 403, **short}]
    _zero_launch_counts()
    with first_decode_logits() as batch_logits:
        ref.generate_mixed(reqs, output_dir=out_dir, save_name="mixed_ref")
    paths["mixed_ref_f32"] = _launch_counts()
    batch_codes, T_text = ref.last_codes, ref.last_timings["T_text"]
    check(T_text == 256, f"mixed reference: T_text {T_text}, want the flagship's 256")
    f32_prefills(paths["mixed_ref_f32"], 1, "mixed reference")
    with first_decode_logits() as alone_logits:
        shares = _alone_shares(ref, reqs[:1], batch_codes, out_dir, "mixed_ref")
    alone_T = ref.last_timings["T_text"]
    shares += _alone_shares(ref, reqs[1:], batch_codes[1:], out_dir, "mixed_ref_rest")
    drift = _first_request_drift(batch_logits, alone_logits)
    print(f"reference check [{card}]: 2-layer flagship-width f32 mixed batch (T2M x2, TTS, "
          f"VT2M; sampled, seeds 400-403; T_text {T_text}, 8 rows, the f32 K1) vs each request "
          f"alone (2 rows) through generate_mixed on the card: frames "
          f"{[len(c) for c in batch_codes]}, equal frames by request "
          f"{[round(x, 4) for x in shares]} (limit {SERVE_REF_EQUAL_SHARE}); the flagship's bf16 "
          f"shares of the mixed phase's first request alone {flagship_shares[0]:.3f} and at the "
          f"batch's T_text {flagship_shares[1]:.3f} (not gated)", flush=True)
    print(f"reference check [{card}]: f32 drift with the batch's shape: codec logits of the "
          f"first request's CFG pair at its first decode step, relative L2 alone (T_text "
          f"{alone_T}) vs in the batch: {drift:.3e}; the flagship's bf16: {flagship_shares[2]:.3e}"
          f" (T_text alone), {flagship_shares[3]:.3e} (the batch's T_text) (not gated)",
          flush=True)
    check(min(shares) >= SERVE_REF_EQUAL_SHARE, f"mixed reference: equal frames {shares}")

    mk = ref.make_slot_request
    secs = SERVE_REF_SECONDS
    reqs = [mk("t2m", caption=caption(6 + 2 * i), seed=300 + i, max_audio_seconds=secs[i],
               rid=f"t2m{i}") for i in range(4)]
    reqs += [mk("vt2m", caption=caption(6), video=vt2m_videos(("C",))[0], seed=304,
                max_audio_seconds=secs[4], rid="vt2m"),
             mk("tts", caption="Hello there.", prompt_text="A short reference.",
                prompt_codec=codec[:15], seed=305, rid="tts", max_audio_seconds=_late_tts_seconds(
                    reqs[0], cfg.max_delay, SERVE_REF_HORIZON, SERVE_REF_CHUNK))]
    t_text = SERVE_T_TEXT
    check(max(r.input_ids.shape[1] for r in reqs) <= t_text,
          f"continuous reference: a request is longer than t_text {t_text}")
    with torch.inference_mode():
        server = SlotServer(params, cfg, slots=SERVE_SLOTS, t_text=t_text,
                            horizon=SERVE_REF_HORIZON, chunk_frames=SERVE_REF_CHUNK,
                            do_sample=False)
        _zero_launch_counts()
        got = _serve_schedule(server, reqs[:4], reqs[4:])
        paths["continuous_ref_f32"] = _launch_counts()
        alone = {r.rid: _slot_standalone(params, cfg, r, t_text) for r in reqs}
    f32_prefills(paths["continuous_ref_f32"], len(reqs), "continuous reference")
    pairs = [(got[k].codes, got[k].length, *alone[k]) for k in alone]
    share = _equal_frame_share(pairs, cfg.max_delay)
    lengths = {k: (got[k].length, alone[k][1]) for k in alone}
    print(f"reference check [{card}]: 2-layer flagship-width f32 continuous server (t_text "
          f"{t_text}, horizon {SERVE_REF_HORIZON}, chunks of {SERVE_REF_CHUNK}, "
          f"{server.compactions} compaction(s), the TTS budget {reqs[5].max_tokens} frames; "
          f"the f32 K1 at every admission) vs each request alone through generate on the card: "
          f"lengths (server, alone) {lengths}; equal frames {share:.4f} (limit "
          f"{SERVE_REF_EQUAL_SHARE})", flush=True)
    check(server.compactions >= 1, "continuous reference: no compaction")
    check(share >= SERVE_REF_EQUAL_SHARE, f"continuous reference: equal frames {share}")

    text = caption(58)
    kw = dict(output_dir=out_dir, max_audio_seconds=SERVE_REF_SPEC_SECONDS, min_audio_seconds=0.5)
    _zero_launch_counts()
    ref.text_to_music_speculative(text, spec_len=SPEC_LEN, draft_layers=1, save_name="spec_ref",
                                  **kw)
    paths["speculative_ref_f32"] = _launch_counts()
    st, spec = ref.last_timings, ref.last_codes[0]
    check(st["T_text"] == 128, f"speculative reference: T_text {st['T_text']}, want 128")
    f32_prefills(paths["speculative_ref_f32"], 1, "speculative reference")
    ref.text_to_music(text, do_sample=False, decode_emit=False, save_name="spec_ref_base", **kw)
    bt, base = ref.last_timings, ref.last_codes[0]
    share = _equal_frame_share([(spec, len(spec), base, len(base))], 0)
    frames, cycles = st["frames"], st["cycles"]
    print(f"reference check [{card}]: 2-layer flagship-width f32 text_to_music_speculative "
          f"(spec_len {SPEC_LEN}, 1 draft layer, T_text {st['T_text']}, the f32 K1) vs greedy "
          f"text_to_music(decode_emit=False): {len(spec)} / {len(base)} frames, {frames} decoded "
          f"in {cycles} cycles (baseline {bt['steps']} steps), accept rate "
          f"{st['accept_rate']:.3f}; equal frames {share:.4f} (limit {SERVE_REF_EQUAL_SHARE})",
          flush=True)
    check(len(spec) == len(base) and frames == bt["steps"]
          and -(-frames // SPEC_LEN) <= cycles <= frames,
          f"speculative reference: lengths {len(spec)} / {len(base)}, frames {frames} vs "
          f"{bt['steps']} steps, {cycles} cycles")
    check(share >= SERVE_REF_EQUAL_SHARE, f"speculative reference: equal frames {share}")
    del params, ref, server
    torch.cuda.empty_cache()
    return paths


def run_speculative(model, card: str, out_dir: str) -> dict:
    """`text_to_music_speculative` (SPEC_*) on one caption that buckets to
    128 tokens (36 K1 launches in its prefill), against greedy
    `text_to_music(decode_emit=False)` on the same prompt: frames, cycles,
    accept rate, ms per frame of both and the share of equal frames (not
    gated: the verify forward's bf16 GEMMs over 4 frames round otherwise
    than one frame's)."""
    tc = model.config.text_config
    text = caption(58)
    kw = dict(output_dir=out_dir, max_audio_seconds=SPEC_SECONDS, min_audio_seconds=1)
    _zero_launch_counts()
    paths = model.text_to_music_speculative(text, spec_len=SPEC_LEN,
                                            draft_layers=SPEC_DRAFT_LAYERS, **kw)
    launches = _launch_counts()
    st, spec = model.last_timings, model.last_codes[0]
    check(launches["flash_attention_fwd"] == tc.num_hidden_layers,
          f"speculative: {launches['flash_attention_fwd']} K1 launches, want "
          f"{tc.num_hidden_layers} (one prefill)")
    check(all(n == 0 for k, n in launches.items() if k != "flash_attention_fwd"),
          f"speculative launched a backward or grouped kernel: {launches}")
    check(len(paths) == 1 and os.path.isfile(paths[0]) and 0 < len(spec) <= SPEC_SECONDS * 50,
          f"speculative: {paths}, {len(spec)} frames")
    model.text_to_music(text, do_sample=False, decode_emit=False, **kw)
    bt, base = model.last_timings, model.last_codes[0]
    share = _equal_frame_share([(spec, len(spec), base, len(base))], 0)
    print(f"serving [{card}]: speculative, spec_len {SPEC_LEN}, {SPEC_DRAFT_LAYERS} draft "
          f"layers: {st['frames']} frames in {st['cycles']} cycles, accept rate "
          f"{st['accept_rate']:.3f}, prefill {st['prefill_s'] * 1e3:.2f} ms, "
          f"{st['decode_s'] * 1e3 / st['frames']:.2f} ms/frame; greedy baseline "
          f"(decode_emit=False) {bt['steps']} frames, prefill {bt['prefill_s'] * 1e3:.2f} ms, "
          f"{bt['decode_s'] * 1e3 / bt['steps']:.2f} ms/frame; codes {len(spec)} / {len(base)} "
          f"frames, equal frames {share:.3f} (not gated); K1 launches "
          f"{launches['flash_attention_fwd']}", flush=True)
    return launches


def run_studio(model, card: str, out_dir: str) -> None:
    """`StudioServer` on 127.0.0.1 at a free port: one POST /api/generate
    of STUDIO_SECONDS of music (through the studio's request batcher), then
    a GET of the wav it names; fails on a non-200 reply or an empty wav."""
    import http.client
    import threading

    from unimoe_audio_torch.apps.web_demo import StudioServer

    studio = StudioServer(model, output_dir=os.path.join(out_dir, "studio"))
    server = studio.make_server("127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        port = server.server_address[1]
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        t0 = time.perf_counter()
        conn.request("POST", "/api/generate", json.dumps(
            {"mode": "music", "text": caption(20), "max_audio_seconds": STUDIO_SECONDS}),
            {"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = resp.read()
        post_s = time.perf_counter() - t0
        check(resp.status == 200, f"studio: POST /api/generate gave {resp.status}: {body[:300]}")
        url = json.loads(body)["audio"]
        conn.request("GET", url)
        resp = conn.getresponse()
        data = resp.read()
        check(resp.status == 200 and data[:4] == b"RIFF" and len(data) > 44,
              f"studio: GET {url} gave {resp.status}, {len(data)} bytes")
        print(f"serving [{card}]: studio on 127.0.0.1:{port}: POST /api/generate "
              f"({STUDIO_SECONDS} s of music) 200 in {post_s:.2f} s, GET {url} 200, "
              f"{len(data)} bytes", flush=True)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
        studio.close()


def run_serving_apps(model, card: str, out_dir: str, stamp=lambda phase: None):
    """The serving apps on the flagship of the earlier phases: a mixed-task
    batch, the continuous slot server (K1 at its admission shape), the
    2-layer f32 reference checks, self-speculative decoding, time to first audio
    (`measure_ttfa`) and the studio's HTTP round trip.  Returns (launch
    counts by path, K1's record at the admission shape)."""
    from unimoe_audio_torch.apps.serve import measure_ttfa

    wav = os.path.join(out_dir, "serving_prompt.wav")
    _two_tone_wav(wav, TTS_PROMPT_SECONDS, TTS_PROMPT_SR)
    mixed, mixed_shares = run_mixed_batch(model, wav, card, out_dir)
    stamp("serving apps: mixed batch")
    continuous, rec = run_continuous(model, wav, card, out_dir)
    stamp("serving apps: continuous server and K1 at its admission shape")
    ref_launches = check_serving_reference(model, card, out_dir, mixed_shares)
    stamp("serving apps: the 2-layer f32 reference checks")
    speculative = run_speculative(model, card, out_dir)
    stamp("serving apps: speculative")
    ttfa = measure_ttfa(model, n_trials=TTFA_TRIALS)
    print(f"serving [{card}]: time to first audio over {ttfa['trials']} trials: p50 "
          f"{ttfa['p50_ttfa_s'] * 1e3:.2f} ms, p90 {ttfa['p90_ttfa_s'] * 1e3:.2f} ms", flush=True)
    run_studio(model, card, out_dir)
    stamp("serving apps: TTFA and the studio")
    return {"t2m_mixed": mixed, "continuous": continuous, "speculative": speculative,
            **ref_launches}, rec


def layer_view(model, n_layers: int):
    """A shallow copy of a `UniMoEAudio` that runs the first n_layers of its
    decoder (the same tensors, the config's depth cut to match)."""
    import dataclasses

    view = copy.copy(model)
    view.config = dataclasses.replace(model.config, text_config=dataclasses.replace(
        model.config.text_config, num_hidden_layers=n_layers))
    view.params = {**model.params, "layers": model.params["layers"][:n_layers]}
    return view


def run_gmm_serving(model, prompts, card: str, out_dir: str) -> dict:
    """The flagship model of the text-to-music slice, cut to its first
    GMM_SERVING_LAYERS layers (`layer_view`), through
    `generate_chunked(..., dispatch_mode="gmm")`: GMM_SERVING_FRAMES frames
    for the same captions, the codes decoded to wavs.  Checks the codes, the
    wavs, and 3 x GMM_SERVING_LAYERS K4 launches per prefill and per decode
    step (no K4t, no K5), in the configuration `gmm_config` picks for each;
    compares the decode's ms per frame with dense dispatch in turns, and the
    device-to-host reads per decode step.  Returns the launch counts of the
    run."""
    import torch
    from unimoe_audio_torch.codec import delay as dl
    from unimoe_audio_torch.ops import grouped_gemm as GG

    depth = model.config.text_config.num_hidden_layers
    model = layer_view(model, GMM_SERVING_LAYERS)
    cfg = model.config
    L = cfg.text_config.num_hidden_layers
    torch.cuda.synchronize()
    _zero_launch_counts()
    res, t = generate_dispatch(model, prompts, "gmm", GMM_SERVING_FRAMES,
                               GMM_SERVING_FRAMES - 20, seed=0)
    launches = _launch_counts()
    want = 3 * L * (1 + res.steps)
    check(launches["grouped_gemm_gmm"] == want,
          f"gmm serving: {launches['grouped_gemm_gmm']} K4 launches, want 3 x {L} x "
          f"(1 prefill + {res.steps} decode steps) = {want}")
    check(launches["grouped_gemm_gmm_transposed"] == launches["grouped_gemm_tgmm"] == 0,
          f"gmm serving launched a backward kernel: {launches}")
    # K4's configuration from A: the prefill's 8 x T rows take the large
    # tiles, each decode step's 8 x 8 (one 128-row tile) the small ones.
    ids, _ = model._tokenize(prompts)
    E = cfg.text_config.mlp_dynamic_expert_num
    by_config = {c: 0 for c in GG.GMM_CONFIGS}
    for S, n in ((ids.shape[0] * ids.shape[1], 1), (ids.shape[0], res.steps)):
        by_config[GG.gmm_config(-(-S * E // 128) * 128)] += 3 * L * n
    got = {c: launches[f"grouped_gemm_gmm_{c}"] for c in GG.GMM_CONFIGS}
    check(got == by_config, f"gmm serving: K4 launches by configuration {got}, want {by_config}")
    codes = res.codes.cpu().numpy()
    lengths = res.lengths.cpu().numpy()
    audios = dl.generate_output(codes, lengths, pad_value=cfg.codec_pad_value,
                                delay_pattern=cfg.codec_delay_pattern)
    paths = [os.path.join(out_dir, f"gmm_{i}.wav") for i in range(len(audios))]
    model.dac.decode_batch([a.T for a in audios], paths, min_duration=1)
    for p, a in zip(paths, audios):
        check(bool((a >= 0).all() and (a < model.dac.config.codebook_size).all()),
              "gmm serving: codes out of range")
        with wave.open(p) as f:
            pcm = np.frombuffer(f.readframes(f.getnframes()), "<i2")
        check(pcm.size > 0 and int(np.abs(pcm).max()) > 0, f"{p}: silent")
    # The decode's ms per frame with dense and gmm dispatch in turns (dense,
    # gmm, gmm, dense), so that both meet the same host; then one short run
    # of each under the profiler.
    turns = ("dense", "gmm", "gmm", "dense")
    per_frame = []
    for m in turns:
        rt, tm = generate_dispatch(model, prompts, m, TURN_FRAMES, TURN_FRAMES, seed=5)
        per_frame.append(tm["decode_s"] * 1e3 / rt.steps)
    profiled = {m: profile_decode(model, prompts, m) for m in ("dense", "gmm")}
    reads = {m: p["reads"] for m, p in profiled.items()}
    check(reads["gmm"] <= reads["dense"],
          f"gmm serving reads the device more often per decode step: {reads}")
    print(f"gmm serving [{card}]: decode ms/frame in turns ({TURN_FRAMES}-frame runs, "
          f"{' / '.join(turns)}): {' / '.join(f'{x:.2f}' for x in per_frame)}", flush=True)
    for m, p in profiled.items():
        print(f"gmm serving [{card}]: {READS_FRAMES} decode steps under the profiler (the "
              f"prefill outside it), {m}: decode "
              f"{p['decode_ms']:.2f} ms/step, device kernel time {p['device_ms']:.2f} ms and "
              f"{p['launches']:.0f} launches per step, {p['reads']:.3f} device-to-host reads "
              f"per step; top kernels (ms, count) {p['top_kernels']}; top host operators "
              f"(self ms, count) {p['top_host']}", flush=True)
    print(f"gmm serving [{card}]: the first {L} of the model's {depth} layers; "
          f"{len(audios)} requests ({len(prompts)} CFG rows), "
          f"{res.steps} decode steps, frames {lengths.tolist()}; prefill {t['prefill_s'] * 1e3:.2f} ms; decode "
          f"{t['decode_s'] * 1e3 / res.steps:.2f} ms/frame; K4 launches "
          f"{launches['grouped_gemm_gmm']} = 3 x {L} x (1 + {res.steps}), by configuration "
          f"{got}; device-to-host reads "
          f"per decode step ({READS_FRAMES}-frame profiled runs): gmm {reads['gmm']:.3f}, dense "
          f"{reads['dense']:.3f}", flush=True)
    return launches


def _serving_kw(model, prompts) -> dict:
    """The dispatch and cache keywords `text_to_music` gives these prompts:
    `model.serving_dispatch` and the model's KV cache type."""
    ids, _ = model._tokenize(prompts)
    kw = model.serving_dispatch(*ids.shape)
    if model.kv_cache_dtype:
        kw["kv_dtype"] = model.kv_cache_dtype
    return kw


def _weight_gb(params) -> dict:
    """Resident bytes of the weights by storage dtype, in GB (packed int4 as
    uint8; the scales under their own dtype)."""
    from unimoe_audio_torch.ops.quant import QTensor

    out: dict = {}
    for leaf in _leaves(params):
        for t in (leaf if isinstance(leaf, QTensor) else (leaf,)):
            k = str(t.dtype).replace("torch.", "")
            out[k] = out.get(k, 0.0) + t.numel() * t.element_size() / 1e9
    return {k: round(v, 3) for k, v in sorted(out.items())}


def run_quantized_t2m(model, captions, seconds: float, min_seconds: float, out_dir: str,
                      label: str, card: str, build_s: float):
    """One text_to_music call of a quantized model with every counter zeroed
    just before it and read just after.  Checks the wavs and codes, one K1
    launch per layer (one prefill), the a8 branch in both DCMoE expert
    groups of every layer of every forward, and (E_dyn + E_fixed) x 3 x L
    int8 expert products per forward.  Returns (launch counts, timings)."""
    import torch
    from unimoe_audio_torch.moe import dispatch as D

    cfg = model.config
    tc = cfg.text_config
    L = tc.num_hidden_layers
    kw = _serving_kw(model, _t2m_prompts(captions))
    _zero_launch_counts()
    D.swiglu_expert_ffn.a8_calls = D.int8_expert_matmul.calls = 0
    paths = model.text_to_music(captions, output_dir=out_dir, save_name=label, seed=0,
                                max_audio_seconds=seconds, min_audio_seconds=min_seconds)
    launches = _launch_counts()
    a8, int_mm = D.swiglu_expert_ffn.a8_calls, D.int8_expert_matmul.calls
    t = model.last_timings
    forwards = 1 + t["steps"]
    check(launches["flash_attention_fwd"] == L,
          f"{label}: {launches['flash_attention_fwd']} K1 launches, want {L} (one prefill)")
    want_a8 = 2 * L * forwards if model.a8_compute else 0
    check(a8 == want_a8, f"{label}: the a8 branch ran {a8} times, want 2 x {L} x {forwards}")
    n_mm = (tc.mlp_dynamic_expert_num + tc.mlp_fixed_expert_num) * 3 * L
    check(int_mm == n_mm * forwards if model.a8_compute else int_mm == 0,
          f"{label}: {int_mm} int8 expert products, want {n_mm} x {forwards}")
    hop, sr = model.dac.config.hop_length, model.dac.config.sample_rate
    check(len(paths) == len(captions), f"{label}: one wav per caption")
    for p, n, c in zip(paths, t["lengths"], model.last_codes):
        check(c.shape == (n, cfg.codec_channels), f"{label}: codes shape {c.shape}")
        check(bool((c >= 0).all() and (c < model.dac.config.codebook_size).all()),
              f"{label}: codes out of range")
        with wave.open(p) as f:
            pcm = np.frombuffer(f.readframes(f.getnframes()), "<i2")
        check(pcm.size == max(n * hop, sr) and int(np.abs(pcm[:n * hop]).max()) > 0,
              f"{p}: {pcm.size} samples for {n} frames, or silent")
    audio_s = sum(t["lengths"]) / 50.0
    gen_s = t["prefill_s"] + t["decode_s"]
    print(f"{label} [{card}]: serving_mode={model.serving_mode!r}, kv_cache_dtype="
          f"{model.kv_cache_dtype!r}, a8_compute={model.a8_compute}; {len(captions)} requests "
          f"({2 * len(captions)} CFG rows), dispatch {kw}; built and quantized in "
          f"{build_s:.1f} s ({', '.join(f'{k} {v:.2f} s' for k, v in model.load_timings.items())}"
          f"); "
          f"weights resident by dtype (GB) {_weight_gb(model.params)}", flush=True)
    print(f"{label} [{card}]: {t['steps']} decode steps, frames {t['lengths']}; prefill "
          f"{t['prefill_s'] * 1e3:.2f} ms; decode {t['decode_s'] * 1e3 / t['steps']:.2f} ms/frame; "
          f"aggregate realtime factor {audio_s / gen_s:.3f} ({audio_s:.2f} s of audio in "
          f"{gen_s:.2f} s); DAC {t['dac_s'] * 1e3:.1f} ms; peak allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; K1 launches "
          f"{launches['flash_attention_fwd']}; a8 branch {a8} = 2 x {L} x {forwards}; int8 "
          f"expert products {int_mm} = {n_mm} per forward", flush=True)
    return launches, t


def check_gmm_quantized(params, card: str) -> None:
    """moe_ffn_gmm on the card over per-channel int8 QTensor experts (K4
    reads q as bf16; each row takes its expert's scales after it), with a
    row for every slot and with an assignment budget of 128 rows below the
    256 selected of S x E = 512 slots, against the same call on CPU tensors
    (the plain grouped product).  Not a main path: the counters are
    restored."""
    import torch
    from unimoe_audio_torch.moe import dispatch as D
    from unimoe_audio_torch.ops.quant import QTensor, wshape

    S = 64
    E, D_ = wshape(params["gate"])[:2]
    gen = torch.Generator(device="cuda").manual_seed(50)
    x = torch.randn(S, D_, generator=gen, device="cuda").to(torch.bfloat16)
    logits = torch.randn(S, E, generator=gen, device="cuda")
    mask = torch.zeros(S, E, dtype=torch.int32, device="cuda").scatter_(
        1, logits.topk(4, dim=-1).indices, 1)
    weight = torch.rand(S, E, generator=gen, device="cuda").to(torch.bfloat16)
    cpu = {k: QTensor(q=v.q.cpu(), s=v.s.cpu()) for k, v in params.items()}
    counts = _launch_counts()
    msgs = []
    for budget in (None, 128):
        before = _launch_counts()["grouped_gemm_gmm"]
        got = D.moe_ffn_gmm(x, mask, weight, params, assignment_budget=budget)
        torch.cuda.synchronize()
        n = _launch_counts()["grouped_gemm_gmm"] - before
        want = D.moe_ffn_gmm(x.cpu(), mask.cpu(), weight.cpu(), cpu,
                             assignment_budget=budget).float()
        o = got.float().cpu()
        err = (o - want).abs()
        rel = ((o - want).norm() / want.norm()).item()
        what = f"gmm over int8 QTensor experts, budget {budget}"
        check(n == 3, f"{what}: {n} K4 launches, want 3")
        ok = bool((err <= GMM_ATOL + GMM_RTOL * want.abs()).all()) and rel <= GMM_REL_L2
        check(bool(torch.isfinite(o).all()) and ok,
              f"{what}: max err {err.max().item()}, relative L2 {rel}")
        msgs.append(f"budget {budget or 'none (' + str(-(-S * E // 128) * 128) + ' rows)'}: "
                    f"max|err| {err.max().item():.3e}, rel L2 {rel:.2e}")
    _set_launch_counts(counts)
    print(f"kernel check [{card}]: moe_ffn_gmm on the card over int8 QTensor experts "
          f"(S {S}, E {E}, top-4) vs the same on the CPU: " + "; ".join(msgs)
          + f" (rtol {GMM_RTOL}, atol {GMM_ATOL}, rel L2 {GMM_REL_L2})", flush=True)


def time_int8_layouts(card: str) -> None:
    """`torch._int_mm` with the weight column-major (K-major, as the port
    stores expert weights) against row-major, at the int4 cell's decode and
    prefill shapes of one expert projection: CUDA-event means, equal int32
    results; and whether a row-major weight runs at all at K 64, N 128."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(60)

    def rint(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int8)

    parts = []
    for m, k, n in ((48, 2048, 2816), (4736, 2048, 2816)):
        a, b = rint(m, k), rint(k, n)
        b_col = b.t().contiguous().t()
        check(torch.equal(torch._int_mm(a, b), torch._int_mm(a, b_col)),
              f"_int_mm {m}x{k}x{n}: the two weight layouts differ")
        ms = {lay: cuda_ms(lambda w=w: torch._int_mm(a, w), iters=100 if m < 100 else 20)
              for lay, w in (("row-major", b), ("K-major", b_col))}
        parts.append(f"[{m}, {k}] x [{k}, {n}]: K-major {ms['K-major']:.4f} ms, row-major "
                     f"{ms['row-major']:.4f} ms")
    try:
        torch._int_mm(rint(24, 64), rint(64, 128))
        torch.cuda.synchronize()
        small = "runs"
    except RuntimeError as e:
        small = f"raises ({str(e).split(' when ')[0][:60]})"
    print(f"int8 products [{card}]: torch._int_mm, equal results in both layouts; "
          + "; ".join(parts) + f"; a row-major [64, 128] weight {small}", flush=True)


def check_quantized_reference(card: str) -> None:
    """A 2-layer model at flagship width in f32 with int8 weights (quantized
    once on the CPU and copied to the card), card vs CPU:

      * packed dispatch and an f32 cache: the prefill's codec logits over
        live rows within QUANT_REF_EXACT_REL_L2 (summation order only);
      * packed_a8 and the int8 KV cache: the prefill's logits and one decode
        step's within QUANT_REF_REL_L2 and within QUANT_REF_VS_NOISE x the
        CPU's own change when its input embeddings move by a relative 1e-7
        (QUANT_REF_NOISE), measured here: the int8 roundings of activations
        and cache entries turn last-bit differences into whole steps;
      * one a8 expert block's int32 products (layer 0's dynamic gate on the
        prefill's quantized block input) equal."""
    import torch
    from unimoe_audio_torch.config import TextMoEConfig, UniMoEAudioConfig
    from unimoe_audio_torch.models import model as M
    from unimoe_audio_torch.models.layers import KVCache
    from unimoe_audio_torch.moe import dispatch as D
    from unimoe_audio_torch.ops import quant as Q

    cfg = UniMoEAudioConfig(text_config=TextMoEConfig(num_hidden_layers=2), vision_config=None)
    tc = cfg.text_config
    cpu = M.init_model_params(cfg, seed=2, dtype=torch.float32, device="cpu")
    Q.pad_expert_ffn(Q.quantize_model_params_inplace(cpu))
    gpu = Q.kmajor_experts(_to(cpu, device="cuda"))
    B, T, T_max = 2, 128, 136
    rng = np.random.default_rng(3)
    ids = rng.integers(0, tc.vocab_size - 8, size=(B, T))
    mask = np.ones((B, T), np.int64)
    mask[0, :40] = 0
    pos = np.where(mask == 0, 1, np.cumsum(mask, -1) - 1)
    kv_valid = np.concatenate([mask, np.zeros((B, T_max - T), np.int64)], -1)
    codes = rng.integers(0, cfg.codec_embed_size, size=(B, 1, cfg.codec_channels))
    live = torch.as_tensor(mask, dtype=torch.bool)

    def run(device, dispatch_mode, kv_dtype, noise: float = 0.0, replay=None):
        params = cpu if device == "cpu" else gpu
        t = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=device)   # noqa: E731
        cache = KVCache.create(tc.num_hidden_layers, B, T_max, tc.num_key_value_heads,
                               tc.head_dim, dtype=kv_dtype, device=device)
        emb = M.calculate_input_embedding(params, t(ids), None, cfg.codec_placeholder_value)
        if noise:
            gen = torch.Generator().manual_seed(9)
            emb = emb * (1 + noise * torch.randn(emb.shape, generator=gen)).to(device)
        tape: list = []
        with router_tape(tape, replay):
            out = M.text_model_forward(params, emb, t(pos)[None].expand(3, B, T), tc,
                                       kv_cache=cache, cache_position=0,
                                       kv_valid_mask=t(kv_valid, torch.int32),
                                       padding_token_mask=t(mask, torch.int32),
                                       dispatch_mode=dispatch_mode, capacity=B * T,
                                       output_moe_inputs=True)
            pre = M.codec_logits_from_hidden(params, out.last_hidden_state, cfg).cpu()[live]
            step_valid = kv_valid.copy()
            step_valid[:, T] = 1
            step = M.text_model_forward(
                params, M.codec_embedding(params, t(codes)),
                t(mask.sum(-1))[None, :, None].expand(3, B, 1), tc, kv_cache=cache,
                cache_position=T, kv_valid_mask=t(step_valid, torch.int32),
                dispatch_mode=dispatch_mode, capacity=B)
        dec = M.codec_logits_from_hidden(params, step.last_hidden_state, cfg).cpu()
        return pre, dec, out.moe_inputs[0].reshape(B * T, -1).cpu(), cache, tape

    # The CPU runs replay the card's routing (router_tape): a token at a
    # near-set boundary would otherwise take other experts at f32 noise.
    flat_live = live.reshape(-1)
    with torch.inference_mode():
        on_card = run("cuda", "packed", torch.float32)
        on_cpu = run("cpu", "packed", torch.float32, replay=on_card[4])
        exact = _rel(on_card[0], on_cpu[0])
        router = {"packed": replay_report(on_card[4], on_cpu[4], tc, flat_live)}
        pre_g, dec_g, _, cache, tape_g = run("cuda", "packed_a8", "int8")
        pre_c, dec_c, moe_in, _, tape_c = run("cpu", "packed_a8", "int8", replay=tape_g)
        pre_n, dec_n, _, _, _ = run("cpu", "packed_a8", "int8", QUANT_REF_NOISE, replay=tape_g)
        router["packed_a8"] = replay_report(tape_g, tape_c, tc, flat_live)
        check(cache.quantized and bool(cache.k_scale[:, T].gt(0).all()),
              "reference check: the decode step did not commit a quantized slot")
        w = cpu["layers"][0]["moe"]["dynamic"]["gate"]
        q, _ = Q.act_quant_int8(moe_in[None].expand(Q.wshape(w)[0], -1, -1))
        prod_c = D.int8_expert_matmul(q, w)
        prod_g = D.int8_expert_matmul(q.cuda(), Q.QTensor(q=Q.kmajor(w.q.cuda()),
                                                         s=w.s.cuda())).cpu()
    errs = {"prefill": (_rel(pre_g, pre_c), _rel(pre_n, pre_c)),
            "decode step": (_rel(dec_g, dec_c), _rel(dec_n, dec_c))}
    check(torch.equal(prod_c, prod_g), "reference check: int32 expert products differ between "
          "the card and the CPU")
    check(exact < QUANT_REF_EXACT_REL_L2,
          f"reference check: int8 weights through packed dispatch, card vs CPU: {exact}")
    # The a8 path's router logits follow the int8 roundings of the layers
    # below them: they are held to its limit, the f32 path's to the VT2M
    # check's.
    check(router["packed"][0] < VT2M_REF_REL_L2 and router["packed_a8"][0] < QUANT_REF_REL_L2,
          f"reference check: router logits, card vs CPU: {router}")
    for what, (card_err, noise_err) in errs.items():
        check(card_err < QUANT_REF_REL_L2 and card_err <= QUANT_REF_VS_NOISE * max(noise_err, 1e-6),
              f"reference check: packed_a8 / int8 cache {what} logits, card vs CPU {card_err}, "
              f"CPU vs CPU with its input moved by {QUANT_REF_NOISE}: {noise_err}")
    print(f"reference check [{card}]: 2-layer flagship-width model, f32, int8 weights, card vs "
          f"CPU, codec logits relative L2: packed dispatch, f32 cache {exact:.3e} (limit "
          f"{QUANT_REF_EXACT_REL_L2}); packed_a8 and the int8 cache " + ", ".join(
              f"{k} {c:.3e} (the CPU moved by its input x (1 + {QUANT_REF_NOISE} N(0, 1)): "
              f"{n:.3e})" for k, (c, n) in errs.items())
          + f" (limits {QUANT_REF_REL_L2}, and {QUANT_REF_VS_NOISE} x the CPU's own move); "
          f"int32 products of layer 0's dynamic gate ({tuple(prod_c.shape)}) equal; under the "
          f"card's routing, router logits relative L2 and route_flips by call: " + ", ".join(
              f"{k} {e:.3e} {f}" for k, (e, f) in router.items()), flush=True)


def run_gptq_slice(card: str) -> None:
    """serving_mode="int4-gptq" through the constructor at full width, cut
    to GPTQ_LAYERS layers: the self-calibration and GPTQ times, and per
    layer the output error of the GPTQ experts on the calibration
    activations against per-channel round-to-nearest int4 of the same
    weights (gate and up on the DCMoE block input X, down on
    silu(X·gate)·(X·up) through the original weights); a short call through
    text_to_music."""
    import torch
    import torch.nn.functional as F
    from unimoe_audio_torch.api import UniMoEAudio
    from unimoe_audio_torch.config import TextMoEConfig, UniMoEAudioConfig
    from unimoe_audio_torch.ops import quant as Q
    from unimoe_audio_torch.ops.gptq import collect_moe_calibration

    cfg = UniMoEAudioConfig(text_config=TextMoEConfig(num_hidden_layers=GPTQ_LAYERS),
                            vision_config=None)
    base = UniMoEAudio(allow_random=True, config=cfg, device="cuda")       # the same weights
    ids, codec, mask = base._calibration_batch(base.GPTQ_CALIB_CAPTIONS, 64)
    X = collect_moe_calibration(base.params, cfg, ids, codec_input_ids=codec,
                                attention_mask=mask)
    t0 = time.perf_counter()
    model = UniMoEAudio(allow_random=True, config=cfg, device="cuda", serving_mode="int4-gptq",
                        kv_cache_dtype="int8")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ratios = []
    with torch.inference_mode():
        for l, (lb, lq) in enumerate(zip(base.params["layers"], model.params["layers"])):
            Xl = X[l]
            e_g = e_r = 0.0
            for g in ("dynamic", "fixed"):
                W = {k: lb["moe"][g][k].float() for k in ("gate", "up", "down")}
                Fn = W["gate"].shape[-1]
                act = F.silu(Xl @ W["gate"]) * (Xl @ W["up"])
                for k, inp in (("gate", Xl), ("up", Xl), ("down", act)):
                    ref = inp @ W[k]
                    Wg = Q.dequantize(lq["moe"][g][k])
                    Wg = Wg[..., :Fn] if k != "down" else Wg[..., :Fn, :]
                    eg = (inp @ Wg - ref).square().sum().item()
                    Wr = Q.dequantize(Q.quantize_tensor_int4(W[k]))
                    er = (inp @ Wr - ref).square().sum().item()
                    ratios.append(f"L{l} {g} {k} {eg / er:.3f}")
                    e_g, e_r = e_g + eg, e_r + er
                del act
            check(e_g < e_r, f"int4-gptq layer {l}: GPTQ output error {e_g} not below RTN's {e_r}")
    t = model.load_timings
    with tempfile.TemporaryDirectory() as out_dir:
        paths = model.text_to_music([caption(n) for n in (58, 74)], output_dir=out_dir, seed=0,
                                    max_audio_seconds=1, min_audio_seconds=0.5)
        check(len(paths) == 2 and all(os.path.getsize(p) > 44 for p in paths),
              "int4-gptq: no wavs")
    print(f"int4-gptq [{card}]: full width, {GPTQ_LAYERS} layers: built in {build_s:.1f} s: "
          f"calibration generation {t['calibration_s']:.2f} s ({len(base.GPTQ_CALIB_CAPTIONS)} "
          f"captions x 64 frames, {int(mask.sum())} calibration tokens, {X.shape[1]} kept), "
          f"GPTQ {t['gptq_s']:.2f} s, int8 pass and padding {t['quantize_s']:.2f} s; output "
          f"error GPTQ / RTN int4 on the calibration activations, by layer, group and "
          f"projection: {', '.join(ratios)}", flush=True)
    del base, model, X


def check_snapshot(model, captions, card: str) -> None:
    """save_serving_snapshot of the model, a new UniMoEAudio loaded from it,
    and greedy codes of both on the same prompts: bit-identical."""
    import torch
    from unimoe_audio_torch.api import UniMoEAudio

    ids, mask = model._tokenize(_t2m_prompts(captions))
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        path = model.save_serving_snapshot(d)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = UniMoEAudio(d, allow_random=True, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        check((loaded.serving_mode, loaded.kv_cache_dtype) == (model.serving_mode,
                                                                model.kv_cache_dtype),
              "snapshot: modes not kept")
        codes = []
        for m in (model, loaded):
            m._generate_core(ids, mask, None, "snapshot", output_dir=d, cfg_scale=10.0,
                             do_sample=False, seed=0, max_tokens=SNAPSHOT_FRAMES,
                             min_tokens=SNAPSHOT_FRAMES // 2)
            codes.append(m.last_codes)
        size_gb = os.path.getsize(path) / 1e9
    check(len(codes[0]) == len(codes[1]) and all(np.array_equal(a, b)
                                                 for a, b in zip(*codes)),
          "snapshot: greedy codes differ after the reload")
    print(f"snapshot [{card}]: {os.path.basename(path)} {size_gb:.2f} GB, saved in {save_s:.1f} s, "
          f"loaded in {load_s:.1f} s; greedy codes of {len(captions)} requests x "
          f"{SNAPSHOT_FRAMES} frames "
          f"bit-identical before and after", flush=True)
    del loaded


def run_serving_modes(card: str) -> None:
    """Every serving_mode x kv_cache_dtype x a8_compute constructs and
    generates through text_to_music on the card, at the tiny test config (2
    layers, hidden 64; prompts of 64 tokens, so the prefill stays off K1,
    whose head dims are 64 and 128): 32 captions, 64 CFG rows, so packed
    dispatch serves the prefill and the decode, with the a8 branch taken
    exactly when a8_compute is on; then `dense_a8` through
    `generate_chunked` once."""
    from unimoe_audio_torch.api import UniMoEAudio
    from unimoe_audio_torch.config import tiny_test_config
    from unimoe_audio_torch.moe import dispatch as D

    cfg = tiny_test_config()
    captions = [caption(8)] * 32
    runs = 0
    with tempfile.TemporaryDirectory() as out_dir:
        for mode in (True, "int8", "int4", "int4-gptq"):
            for kv in (None, "int8"):
                for a8 in (True, False):
                    model = UniMoEAudio(allow_random=True, config=cfg, device="cuda",
                                        serving_mode=mode, kv_cache_dtype=kv, a8_compute=a8,
                                        gptq_calibration={"frames": 8})
                    D.swiglu_expert_ffn.a8_calls = 0
                    paths = model.text_to_music(captions, output_dir=out_dir, seed=0,
                                                max_audio_seconds=0.4, min_audio_seconds=0.2)
                    what = f"serving_mode={mode!r}, kv_cache_dtype={kv!r}, a8_compute={a8}"
                    check(len(paths) == len(captions) and all(os.path.isfile(p) for p in paths),
                          f"{what}: no wavs")
                    check((D.swiglu_expert_ffn.a8_calls > 0) == a8,
                          f"{what}: {D.swiglu_expert_ffn.a8_calls} a8 branches")
                    runs += 1
        before = D.swiglu_expert_ffn.a8_calls
        res, _ = generate_dispatch(model, _t2m_prompts(captions[:4]), "dense_a8", 8, 8, seed=1)
        check(res.steps > 0 and D.swiglu_expert_ffn.a8_calls > before,
              "dense_a8 through generate_chunked did not take the a8 branch")
    print(f"serving modes [{card}]: {runs} serving_mode x kv_cache_dtype x a8_compute settings "
          f"constructed and generated 32 requests each at the tiny config; dense_a8 through "
          f"generate_chunked", flush=True)


def run_quantized_serving(card: str, stamp=lambda phase: None) -> dict:
    """The quantized serving phase: the flagship in int4 (the north star:
    int4 experts, packed_a8, the int8 KV cache) on QUANT_CAPTIONS captions
    through text_to_music and its snapshot round trip; the flagship in int8
    (its vision tower int8 too) on the T2M phase's captions, then one short
    video_text_to_music call; both in turns on those captions; gmm over
    int8 QTensors with and without a budget; the reference check; int4-gptq
    at GPTQ_LAYERS layers.  Returns the launch counts of the int4 and int8
    text_to_music runs and of the int8 VT2M call."""
    import torch
    from unimoe_audio_torch.api import UniMoEAudio
    from unimoe_audio_torch.config import TextMoEConfig, UniMoEAudioConfig

    cfg = UniMoEAudioConfig(text_config=TextMoEConfig(), vision_config=None)
    # The int8 model also carries the vision tower (int8 too).
    cfg_vision = UniMoEAudioConfig(text_config=TextMoEConfig())
    lengths = (58, 74, 90, 106)
    captions = [caption(lengths[i % 4]) for i in range(QUANT_CAPTIONS)]
    small = [caption(n) for n in lengths]
    models, launches = {}, {}
    with tempfile.TemporaryDirectory() as out_dir:
        for mode, kv, caps, seconds in (("int4", "int8", captions, QUANT_INT4_SECONDS),
                                        ("int8", None, small, QUANT_INT8_SECONDS)):
            label = f"t2m_{mode}"
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            model = UniMoEAudio(allow_random=True, config=cfg_vision if mode == "int8" else cfg,
                                device="cuda", serving_mode=mode, kv_cache_dtype=kv)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            model.text_to_music(caps, output_dir=out_dir, save_name="warmup", seed=1,
                                max_audio_seconds=0.6, min_audio_seconds=0.4)
            launches[label], t = run_quantized_t2m(model, caps, seconds, seconds / 2, out_dir,
                                                   label, card, build_s)
            if mode == "int4":
                check(t["steps"] > 256, f"{label}: {t['steps']} decode steps: no chunk crossed")
                prompts = _t2m_prompts(caps)
                kw = _serving_kw(model, prompts)
                p = profile_decode(model, prompts, kw.pop("dispatch_mode", "dense"), **kw)
                print(f"{label} [{card}]: {READS_FRAMES} decode steps under the profiler "
                      f"(the prefill outside it): decode {p['decode_ms']:.2f} ms/step, device "
                      f"kernel time {p['device_ms']:.2f} ms ({100 * p['device_ms'] / p['decode_ms']:.1f} "
                      f"% busy) and {p['launches']:.0f} launches per step; top kernels (ms, count) "
                      f"{p['top_kernels']}; top host operators (self ms, count) "
                      f"{p['top_host']}", flush=True)
                stamp("int4 serving and its profile")
                check_snapshot(model, small, card)
                stamp("int4 snapshot round trip")
            else:
                launches["vt2m_int8"] = run_vt2m_int8(model, card, out_dir)
                stamp("int8 serving and its VT2M call")
            models[mode] = model
    # int8 and int4 decode on the same 4 captions, in turns (int8, int4, int4, int8).
    prompts = _t2m_prompts(small)
    per_frame = []
    for mode in ("int8", "int4", "int4", "int8"):
        kw = _serving_kw(models[mode], prompts)
        res, tm = generate_dispatch(models[mode], prompts, kw.pop("dispatch_mode", "dense"),
                                    TURN_FRAMES, TURN_FRAMES, seed=5, **kw)
        per_frame.append(tm["decode_s"] * 1e3 / res.steps)
    print(f"quantized serving [{card}]: decode ms/frame in turns on {len(small)} requests "
          f"({TURN_FRAMES}-frame runs, int8 / int4 / int4 / int8, packed_a8 at capacity S): "
          f"{' / '.join(f'{x:.2f}' for x in per_frame)}", flush=True)
    check_gmm_quantized(models["int8"].params["layers"][0]["moe"]["dynamic"], card)
    time_int8_layouts(card)
    stamp("int8 / int4 turns, gmm over int8 QTensors, _int_mm layouts")
    del models, model
    torch.cuda.empty_cache()
    check_quantized_reference(card)
    stamp("quantized reference check")
    torch.cuda.empty_cache()
    run_gptq_slice(card)
    stamp("int4-gptq")
    torch.cuda.empty_cache()
    run_serving_modes(card)
    return launches


def _grouped_library(kind: str, x, w, dy, gs):
    """One PyTorch call computing the same function, for timing only:
    torch._grouped_mm where this PyTorch has it (bf16 output; for tgmm on
    copies of x and dy whose groups are zero-padded to multiples of 8 rows,
    as it requires, which leaves every dW[g] the same), else a per-group
    torch.matmul loop.  Returns (fn, label)."""
    import torch

    dyb = dy.to(torch.bfloat16)
    sizes = [int(n) for n in gs.tolist()]
    starts = np.concatenate([[0], np.cumsum(sizes)]).astype(int)
    if hasattr(torch, "_grouped_mm"):
        offs = torch.cumsum(gs, 0, dtype=torch.int32)
        if kind == "gmm":
            wt = w.transpose(1, 2).contiguous().transpose(1, 2)        # column-major W[g]
            return (lambda: torch._grouped_mm(x, wt, offs=offs)), "torch._grouped_mm"
        if kind == "gmm_transposed":
            return (lambda: torch._grouped_mm(dyb, w.transpose(1, 2), offs=offs)), \
                "torch._grouped_mm"
        padded = [-(-n // 8) * 8 for n in sizes]
        pstarts = np.concatenate([[0], np.cumsum(padded)]).astype(int)
        xp = x.new_zeros(int(pstarts[-1]), x.shape[1])
        dp = dyb.new_zeros(int(pstarts[-1]), dy.shape[1])
        for g, n in enumerate(sizes):
            xp[pstarts[g]:pstarts[g] + n] = x[starts[g]:starts[g] + n]
            dp[pstarts[g]:pstarts[g] + n] = dyb[starts[g]:starts[g] + n]
        xt, dyc = xp.t().contiguous(), dp.t().contiguous().t()
        poffs = torch.tensor(pstarts[1:], dtype=torch.int32, device=x.device)
        return (lambda: torch._grouped_mm(xt, dyc, offs=poffs)), \
            "torch._grouped_mm (groups zero-padded to 8 rows)"
    spans = [(g, int(a), int(b)) for g, (a, b) in enumerate(zip(starts[:-1], starts[1:])) if b > a]
    if kind == "gmm":
        fn = lambda: [torch.matmul(x[a:b], w[g]) for g, a, b in spans]          # noqa: E731
    elif kind == "gmm_transposed":
        fn = lambda: [torch.matmul(dyb[a:b], w[g].t()) for g, a, b in spans]    # noqa: E731
    else:
        fn = lambda: [torch.matmul(x[a:b].t(), dyb[a:b]) for g, a, b in spans]  # noqa: E731
    return fn, "per-group torch.matmul"


def _tgmm_split_groups(gs, A: int):
    """(group, first workspace slot, chunks) of each group K5 splits into
    more than one chunk, numbered as the kernel numbers them."""
    from unimoe_audio_torch.ops.grouped_gemm import TGMM_CHUNK_ROWS as R

    out, start, slot = [], 0, 0
    for g, n in enumerate(gs.tolist()):
        end = min(start + max(int(n), 0), A)
        c = -(-(end - start) // R)
        if c > 1:
            out.append((g, slot, c))
            slot += c
        start = end
    return out


def time_grouped(errs: dict, card: str) -> list:
    """K4 at the training gate/up and down shapes and at the T2M prefill and
    decode shapes (group sizes from the flagship router), K4t and K5 at the
    training gate/up shape: kernel, plain version and one library call, with
    the bound over what these group sizes need, its share and the achieved
    rate.  K5's time includes the rounding of its f32 dy and its reduction;
    both are also timed apart, and the reduction gets its own record."""
    import torch
    from unimoe_audio_torch.config import TextMoEConfig
    from unimoe_audio_torch.ops import grouped_gemm as GG

    tc = TextMoEConfig()
    D, Fd, E = tc.hidden_size, tc.dynamic_intermediate_size, tc.mlp_dynamic_expert_num
    counts = _launch_counts()

    def bound(nbytes, flops):
        tb, to = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_BF16_FLOPS * 1e3
        return max(tb, to), ("bytes" if tb >= to else "operations"), nbytes, flops

    def rate(b, ms):
        """Share of the bound, and the achieved rate in the bound's unit."""
        if b[1] == "bytes":
            return f"{100 * b[0] / ms:.1f} % of the bound, {b[2] / ms / 1e6:.1f} GB/s"
        return f"{100 * b[0] / ms:.1f} % of the bound, {b[3] / ms / 1e9:.1f} TFLOP/s"

    ms_by, lib_by, bound_by, dev_by, lib_dev_by = {}, {}, {}, {}, {}

    def k4_case(key, S, K, N, seed):
        gs, A = flagship_group_sizes(S, seed)
        x, w, dy = grouped_operands(A, K, N, E, seed + 1)
        live = int((gs > 0).sum())
        b = bound(A * K * 2 + live * K * N * 2 + A * N * 4 + E * 4, 2 * A * K * N)
        iters = 20 if A > 128 else 200
        ms_by[key] = cuda_ms(lambda: GG.gmm(x, w, gs), iters=iters)
        lib_fn, lib_label = _grouped_library("gmm", x, w, dy, gs)
        lib_by[key] = cuda_ms(lib_fn, iters=iters)
        bound_by[key] = b[0]
        g_iters = 10 if A > 128 else 50
        dev_by[key] = graph_ms(lambda: GG.gmm(x, w, gs), g_iters)
        lib_dev_by[key] = graph_ms(lib_fn, g_iters)
        for label, t in (("kernel", ms_by[key]), ("kernel, graph", dev_by[key]),
                         (lib_label, lib_by[key]), (f"{lib_label}, graph", lib_dev_by[key])):
            check_rate(f"grouped_gemm_gmm {key}, {label}", t, b[2], b[3])
        enqueue = {}                        # host time to enqueue one call (no synchronise)
        for label, fn in (("kernel", lambda: GG.gmm(x, w, gs)), ("library", lib_fn)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                fn()
            enqueue[label] = (time.perf_counter() - t0) / 20 * 1e3
            torch.cuda.synchronize()

        def dev(v):
            return "not measured" if v is None else f"{v:.4f} ms"

        print(f"kernel timing [{card}]: grouped_gemm_gmm {key} A={A} K={K} N={N} groups "
              f"{gs.tolist()}, {GG.gmm_config(A)} configuration: kernel {ms_by[key]:.4f} ms "
              f"({rate(b, ms_by[key])}; graph replay, L2 cold {dev(dev_by[key])}), "
              f"{lib_label} {lib_by[key]:.4f} ms (graph replay {dev(lib_dev_by[key])}), bound "
              f"{b[0]:.4f} ms by {b[1]} ({b[2] / 1e6:.1f} MB, {b[3] / 1e9:.1f} GFLOP); host "
              f"enqueue per call: kernel {enqueue['kernel']:.4f} ms, library "
              f"{enqueue['library']:.4f} ms", flush=True)
        return b, (x, w, dy, gs)

    k4_case("train_down", TRAIN_B * TRAIN_T, Fd, D, 40)
    k4_case("t2m_prefill", 8 * 128, D, Fd, 42)
    k4_case("t2m_decode", 8, D, Fd, 44)
    b_k4, (x, w, dy, gs) = k4_case("train_gate_up", TRAIN_B * TRAIN_T, D, Fd, 46)
    A, K, N = x.shape[0], D, Fd
    live = int((gs > 0).sum())

    # K5's parts: the rounding of dy, the main kernel, the reduction.
    dyb = dy.to(torch.bfloat16)
    slots = GG.tgmm_workspace_slots(A, E)
    dw = torch.empty(E, K, N, dtype=torch.bfloat16, device="cuda")
    conv_ms = cuda_ms(lambda: dy.to(torch.bfloat16), iters=20)
    main_reduce_ms = cuda_ms(lambda: GG.launch_tgmm(x, dyb, gs, dw), iters=20)
    ws = GG.launch_tgmm(x, dyb, gs, dw)                 # the partials the reduction reads
    reduce_ms = cuda_ms(lambda: GG.launch_tgmm_reduce(ws, gs, dw, A), iters=20)
    split = _tgmm_split_groups(gs, A)
    used = sum(c for _, _, c in split)
    print(f"kernel timing [{card}]: grouped_gemm_tgmm parts at A={A} K={K} N={N}: dy f32 -> bf16 "
          f"{conv_ms:.4f} ms, main kernel + reduction {main_reduce_ms:.4f} ms, reduction alone "
          f"{reduce_ms:.4f} ms; groups split into chunks (group, first slot, chunks) {split}; "
          f"workspace {slots} slots allocated ({slots * K * N * 4 / 1e6:.1f} MB), {used} written "
          f"({used * K * N * 4 / 1e6:.1f} MB)", flush=True)

    # K4t with the bf16 dy the training step gives it, and with an f32 dy
    # (its rounding included), its device time under the profiler.
    k4t_f32_ms = cuda_ms(lambda: GG.gmm(dy, w, gs, transpose_rhs=True), iters=20)
    k4t_dev = graph_ms(lambda: GG.gmm(dyb, w, gs, transpose_rhs=True), 10)
    k4t_lib_dev = graph_ms(_grouped_library("gmm_transposed", x, w, dy, gs)[0], 10)

    recs = []
    for name, kind, fn, plain, b in (
            ("grouped_gemm_gmm", "gmm", None, lambda: GG.gmm_reference(x, w, gs), b_k4),
            ("grouped_gemm_gmm_transposed", "gmm_transposed",
             lambda: GG.gmm(dyb, w, gs, transpose_rhs=True),
             lambda: GG.gmm_reference(dyb, w, gs, transpose_rhs=True),
             bound(A * N * 2 + live * K * N * 2 + A * K * 2, 2 * A * K * N)),
            ("grouped_gemm_tgmm", "tgmm", lambda: GG.tgmm(x, dy, gs, E),
             lambda: GG.tgmm_reference(x, dy, gs, E),
             bound(A * K * 2 + A * N * 4 + E * K * N * 2, 2 * A * K * N))):
        ms = ms_by["train_gate_up"] if fn is None else cuda_ms(fn, iters=20)
        plain_ms = cuda_ms(plain, iters=2, warmup=1)
        lib_fn, lib_label = _grouped_library(kind, x, w, dy, gs)
        lib_ms = cuda_ms(lib_fn, iters=20)
        check_rate(f"{name} at the training shape, kernel", ms, b[2], b[3])
        check_rate(f"{name} at the training shape, {lib_label}", lib_ms, b[2], b[3])
        if lib_label.startswith("torch._grouped_mm"):      # the yardstick computes the same
            lib_err = (lib_fn().float() - plain().float()).abs().max().item()
            lib_label += f", max |diff| vs plain {lib_err:.3e}"
        rec = {
            "name": name,
            "route": "cuda",
            "source": "unimoe_audio_torch/csrc/grouped_gemm.cu",
            "replaces": ("jax/experimental/pallas/ops/tpu/megablox/gmm.py:573" if kind == "tgmm"
                         else "jax/experimental/pallas/ops/tpu/megablox/gmm.py:314"),
            "max_abs_err": errs[name],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": b[0],
            "bound_by": b[1],
            "library_ms": lib_ms,
            "library": lib_label,
        }
        if kind == "gmm":
            rec.update(ms_by_shape=ms_by, library_ms_by_shape=lib_by, bound_ms_by_shape=bound_by,
                       device_ms_graph_by_shape=dev_by,
                       library_device_ms_graph_by_shape=lib_dev_by)
        if kind == "gmm_transposed":
            rec.update(dy_dtype="bfloat16", ms_f32_dy=k4t_f32_ms, device_ms_graph=k4t_dev,
                       library_device_ms_graph=k4t_lib_dev)
            for label, t in (("f32 dy", k4t_f32_ms), ("graph", k4t_dev),
                             ("library, graph", k4t_lib_dev)):
                check_rate(f"{name}, {label}", t, b[2], b[3])
            print(f"kernel timing [{card}]: {name}: with an f32 dy (rounded to bf16 before the "
                  f"launch) {k4t_f32_ms:.4f} ms; graph replay (L2 cold), bf16 dy: kernel "
                  f"{'not measured' if k4t_dev is None else f'{k4t_dev:.4f} ms'}, library "
                  f"{'not measured' if k4t_lib_dev is None else f'{k4t_lib_dev:.4f} ms'}",
                  flush=True)
        if kind == "tgmm":
            t5 = graph_ms(fn, 10)
            t5_lib = graph_ms(lib_fn, 10)
            for label, t in (("graph", t5), ("library, graph", t5_lib)):
                check_rate(f"{name}, {label}", t, b[2], b[3])
            rec.update(ms_parts={"dy_to_bf16": conv_ms, "main": main_reduce_ms - reduce_ms,
                                 "reduction": reduce_ms},
                       workspace_bytes=slots * K * N * 4, workspace_bytes_written=used * K * N * 4,
                       device_ms_graph=t5, library_device_ms_graph=t5_lib)
            print(f"kernel timing [{card}]: {name}: graph replay (L2 cold), f32 dy, its rounding "
                  f"and the reduction included: kernel "
                  f"{'not measured' if t5 is None else f'{t5:.4f} ms'}, library "
                  f"{'not measured' if t5_lib is None else f'{t5_lib:.4f} ms'}", flush=True)
        print(f"kernel timing [{card}]: {name} at the training shape A={A} K={K} N={N}: kernel "
              f"{ms:.4f} ms ({rate(b, ms)}), plain {plain_ms:.4f} ms, library ({lib_label}) "
              f"{lib_ms:.4f} ms, bound {b[0]:.4f} ms by {b[1]} ({b[2] / 1e6:.1f} MB, "
              f"{b[3] / 1e9:.1f} GFLOP)", flush=True)
        print(json.dumps({"kernel": rec}), flush=True)
        recs.append(rec)

    # The reduction against its plain version on the partials the main
    # kernel left in ws (dw holds its result from the timing above).
    check(len(split) > 0, f"the training shape split no group into chunks: {gs.tolist()}")

    def reduce_plain():
        return [ws[f:f + c].sum(0).to(torch.bfloat16) for _, f, c in split]

    want = reduce_plain()
    err = max((dw[g].float() - r.float()).abs().max().item() for (g, _, _), r in zip(split, want))
    check(all(bool(((dw[g].float() - r.float()).abs() <= GMM_ATOL + GMM_RTOL * r.float().abs())
                   .all()) for (g, _, _), r in zip(split, want)),
          f"tgmm reduction differs from the plain sum of its partials: max err {err}")
    red_plain_ms = cuda_ms(reduce_plain, iters=5, warmup=1)
    red_bytes = used * K * N * 4 + len(split) * K * N * 2
    check_rate("grouped_gemm_tgmm_reduce, kernel", reduce_ms, red_bytes, 0)
    red_lib_ms = None
    if len(split) == 1:                       # one torch.sum computes the same sums
        _, f, c = split[0]
        red_lib_ms = cuda_ms(lambda: torch.sum(ws[f:f + c], 0), iters=20)
        check_rate("grouped_gemm_tgmm_reduce, torch.sum", red_lib_ms, red_bytes, 0)
    b = bound(used * K * N * 4 + len(split) * K * N * 2 + E * 4, 0)    # f32 adds: bytes bound it
    rec = {
        "name": "grouped_gemm_tgmm_reduce",
        "route": "cuda",
        "source": "unimoe_audio_torch/csrc/grouped_gemm.cu",
        "replaces": "jax/experimental/pallas/ops/tpu/megablox/gmm.py:573",
        "max_abs_err": err,
        "ms": reduce_ms,
        "plain_ms": red_plain_ms,
        "bound_ms": b[0],
        "bound_by": b[1],
        "library_ms": red_lib_ms,
        "library": "torch.sum over the group's partials" if red_lib_ms is not None else None,
    }
    print(f"kernel timing [{card}]: grouped_gemm_tgmm_reduce at A={A} K={K} N={N}, {used} "
          f"partials of {len(split)} group(s): kernel {reduce_ms:.4f} ms ({rate(b, reduce_ms)}), "
          f"plain {red_plain_ms:.4f} ms, torch.sum "
          f"{'not one call' if red_lib_ms is None else f'{red_lib_ms:.4f} ms'}, bound "
          f"{b[0]:.4f} ms by {b[1]}; max |err| vs plain {err:.3e}", flush=True)
    print(json.dumps({"kernel": rec}), flush=True)
    recs.append(rec)
    _set_launch_counts(counts)
    return recs


def _greedy_t2m(model, prompts, n_frames: int):
    """Greedy codes [B, n_frames, C] of `generate_chunked` over the prompts'
    CFG pairs, dense dispatch."""
    res, _ = generate_dispatch(model, prompts, "dense", n_frames, n_frames, 0, do_sample=False)
    return res.codes.cpu()


def run_export(model, prompts, card: str) -> dict:
    """The HF-layout export of the flagship cut to MESH_LAYERS layers
    (`layer_view`), bf16: its bytes and seconds, then the reload through
    `UniMoEAudio(dir)`, whose greedy codes must equal the source's.  The
    source's router gates are rounded to bf16 first (the model keeps them in
    f32; the bf16 export and the loader's cast round them), so that source
    and reload hold the same numbers.  Returns the reload run's launch
    counts."""
    import torch
    from unimoe_audio_torch.api import UniMoEAudio
    from unimoe_audio_torch.core.export import export_hf_checkpoint

    view = layer_view(model, MESH_LAYERS)
    view.params = {**view.params, "layers": [
        {**lp, "moe": {**lp["moe"], "gate": lp["moe"]["gate"].to(torch.bfloat16)}}
        for lp in view.params["layers"]]}
    with tempfile.TemporaryDirectory() as d:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = export_hf_checkpoint(view.params, view.config, d, dtype="bfloat16")
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        reload = UniMoEAudio(d, dtype=torch.bfloat16, tokenizer=model.tokenizer,
                             device=model.device)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    as_json = lambda c: json.loads(json.dumps(c.to_dict(), default=list))   # noqa: E731
    check(as_json(reload.config) == as_json(view.config), "export: the reload's config differs")
    src = _greedy_t2m(view, prompts[:2 * MESH_PROMPTS], MESH_FRAMES)
    _zero_launch_counts()
    got = _greedy_t2m(reload, prompts[:2 * MESH_PROMPTS], MESH_FRAMES)
    launches = _launch_counts()
    check(torch.equal(got, src), "export: the reload's greedy codes differ from the source's in "
          f"{int((got != src).sum())} of {got.numel()}")
    print(f"export [{card}]: the flagship cut to {MESH_LAYERS} layers as model.safetensors + "
          f"config.json (bf16, the port's writer): {n / 1e9:.3f} GB in {export_s:.2f} s "
          f"({n / 1e9 / export_s:.2f} GB/s); reload through UniMoEAudio {load_s:.2f} s; greedy "
          f"codes of {MESH_PROMPTS} captions x {MESH_FRAMES} frames equal to the source's; K1 "
          f"launches {launches['flash_attention_fwd']}", flush=True)
    del reload
    torch.cuda.empty_cache()
    return launches


def run_mesh_serving(model, prompts, card: str) -> dict:
    """Serving on a 1 x 1 x 1 mesh over NCCL (`UniMoEAudio.use_mesh`, what
    `build_server` does on several ranks) of the flagship cut to
    MESH_LAYERS layers: greedy codes equal to the mesh-less view's; and a
    training forward with dispatch_mode="ep" under the mesh's split batch
    against dense.  Returns the mesh serving run's launch counts."""
    import torch
    from unimoe_audio_torch.parallel.mesh import make_mesh, set_mesh, use_mesh
    from unimoe_audio_torch.train.step import loss_fn

    view = layer_view(model, MESH_LAYERS)
    want = _greedy_t2m(view, prompts[:2 * MESH_PROMPTS], MESH_FRAMES)
    t0 = time.perf_counter()
    mesh = make_mesh(1, 1, 1, device="cuda")
    mesh_s = time.perf_counter() - t0
    served = layer_view(model, MESH_LAYERS)
    served.use_mesh(mesh)
    try:
        _zero_launch_counts()
        got = _greedy_t2m(served, prompts[:2 * MESH_PROMPTS], MESH_FRAMES)
        launches = _launch_counts()
    finally:
        set_mesh(None)
    check(torch.equal(got, want) and launches["flash_attention_fwd"] > 0,
          f"mesh serving: codes differ in {int((got != want).sum())}, K1 launches "
          f"{launches['flash_attention_fwd']}")
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in probe_batch(view.config, B=2, T=512).items()}
    with torch.no_grad(), use_mesh(mesh, split_batch=True):
        ep = float(loss_fn(view.params, view.config, batch, 0, 0.01, dispatch_mode="ep",
                           remat=False)[0])
    with torch.no_grad():
        dense = float(loss_fn(view.params, view.config, batch, 0, 0.01, remat=False)[0])
    rel = abs(ep - dense) / abs(dense)
    check(rel <= TRAIN_LOSS_REL, f"ep dispatch under the mesh: loss {ep} vs dense {dense}")
    print(f"mesh serving [{card}]: NCCL process group of one rank and the 1 x 1 x 1 mesh in "
          f"{mesh_s:.2f} s; the flagship cut to {MESH_LAYERS} layers on it: greedy codes of "
          f"{MESH_PROMPTS} captions x {MESH_FRAMES} frames equal to the mesh-less run's, K1 "
          f"launches {launches['flash_attention_fwd']}; a bf16 training forward (B 2 x T 512) "
          f"with dispatch_mode='ep' under the split batch: loss {ep:.5f} vs dense {dense:.5f} "
          f"(relative {rel:.2e}, limit {TRAIN_LOSS_REL})", flush=True)
    return launches


def run_mesh_training(card: str) -> dict:
    """`Trainer(mesh=make_mesh(1, 1, 1), fsdp=True)` at the flagship width
    cut to MESH_LAYERS layers, bf16, the train probe's batch,
    MESH_TRAIN_STEPS steps, beside the same Trainer without a mesh: losses
    within TRAIN_LOSS_REL, the parameters' difference within
    TRAIN_ACCUM_REL of the update; K1-K3 launched; step seconds.  Returns
    the mesh run's launch counts and the mesh-less run's history."""
    import dataclasses

    import torch
    from unimoe_audio_torch.config import TextMoEConfig, UniMoEAudioConfig
    from unimoe_audio_torch.models.model import init_model_params
    from unimoe_audio_torch.parallel.mesh import make_mesh
    from unimoe_audio_torch.train.trainer import Trainer, TrainerConfig

    cfg = UniMoEAudioConfig(text_config=dataclasses.replace(
        TextMoEConfig(), num_hidden_layers=MESH_LAYERS), vision_config=None)
    batch = probe_batch(cfg)
    tcfg = TrainerConfig(learning_rate=1e-4, warmup_steps=0, total_steps=100, log_every=1)
    runs = {}
    for name, mesh in (("plain", None), ("mesh", make_mesh(1, 1, 1, device="cuda"))):
        params = init_model_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
        p0 = [t.detach().clone() for t in _leaves(params)] if name == "plain" else None
        tr = Trainer(cfg, params, tcfg, mesh=mesh, fsdp=mesh is not None, device="cuda")
        _zero_launch_counts()
        hist, _, marks = _fit_marked(tr, batch, MESH_TRAIN_STEPS)
        runs[name] = (hist, _param_leaves(tr), _durations(marks), _launch_counts(), p0)
        del tr, params
        torch.cuda.empty_cache()
    (h0, q0, _, _, p0), (h1, q1, secs, launches, _) = runs["plain"], runs["mesh"]
    loss_rel = max(abs(a["loss"] - b["loss"]) / abs(a["loss"]) for a, b in zip(h0, h1))
    upd = _leaf_diff(q0, p0)[2]
    diff = _leaf_diff(q1, q0)
    check(loss_rel <= TRAIN_LOSS_REL and diff[2] <= TRAIN_ACCUM_REL * upd
          and all(launches[k] > 0 for k in ("flash_attention_fwd", "flash_attention_bwd_dq",
                                            "flash_attention_bwd_dkv")),
          f"mesh training: loss relative {loss_rel}, parameters {diff} vs an update of {upd}, "
          f"launches {launches}")
    print(f"mesh training [{card}]: Trainer(mesh=1 x 1 x 1, NCCL, fsdp=True), the flagship cut "
          f"to {MESH_LAYERS} layers, bf16, B {TRAIN_B} x T {TRAIN_T}, {MESH_TRAIN_STEPS} steps: "
          f"losses {[round(h['loss'], 5) for h in h1]} vs mesh-less "
          f"{[round(h['loss'], 5) for h in h0]} (relative {loss_rel:.2e}, limit "
          f"{TRAIN_LOSS_REL}); parameters differ in {diff[1]} elements, L2 {diff[2]:.3e} "
          f"against the update's {upd:.3e} (limit {TRAIN_ACCUM_REL} of it); step seconds "
          f"{[round(x, 4) for x in secs]}; launches per step {_per_step(launches, MESH_TRAIN_STEPS)}",
          flush=True)
    return launches, h0


def run_ring(card: str, plain_hist) -> dict:
    """Ring attention at world size 1 (NCCL), bf16, flagship widths (H 16,
    KV 2, Dh 128):
      (a) the ring steps composed over RING_CHUNKS chunks at B 1 x T RING_T
          against K1 over the whole sequence, and the peak memory of one
          chunk step beside that of one f32 [1, 16, T, T] score block;
      (b) `ring_attention` on the mesh's model group (one rank) at the
          training shape against K1;
      (c) `Trainer(mesh=make_mesh(1, 1, 1), TrainerConfig(ring_axis=
          "model"))` at the mesh trainer's cut beside its mesh-less run
          (`plain_hist`): losses within TRAIN_LOSS_REL, step seconds, peak
          GB; tensor parallelism off (`tr.plan.model` False);
      (d) the same with `ring_axis="data"` and with `ring_axis="expert"`:
          tensor parallelism stays on (`tr.plan.model` True).  At world
          size 1 the ring's row-for-chunk exchange (`comm.rows_to_chunks`)
          is the identity, and a ring of one rank takes the same-rows
          branch; the CPU tests' four gloo ranks hold the exchange itself.
    The K1 launches of (a) and (b) are comparisons and leave the counts as
    they were; each trainer's run is counted from 0 and launches no kernel
    of the table (its attention is the ring's einsum arithmetic).  Returns
    {axis: that run's launch counts}."""
    import dataclasses

    import torch
    from unimoe_audio_torch.config import TextMoEConfig, UniMoEAudioConfig
    from unimoe_audio_torch.models.model import init_model_params
    from unimoe_audio_torch.ops import ring_attention as RA
    from unimoe_audio_torch.ops.flash_attention import flash_attention
    from unimoe_audio_torch.parallel.mesh import make_mesh
    from unimoe_audio_torch.train.trainer import Trainer, TrainerConfig

    saved = _launch_counts()
    H, KV, Dh = 16, 2, 128
    T, p = RING_T, RING_CHUNKS
    q, k, v, valid = flash_inputs(1, H, KV, T, T, Dh, np.ones((1, T), np.int32), seed=40)
    want = flash_attention(q, k, v, valid)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = RA.compose_ring(q, k, v, valid, p)
    torch.cuda.synchronize()
    ring_s = time.perf_counter() - t0
    err = (got.float() - want.float()).abs()
    check(bool(torch.isfinite(got).all())
          and bool((err <= RING_ATOL + RING_RTOL * want.float().abs()).all()),
          f"ring: the composed ring at T {T} differs from K1, max err {err.max().item()}")
    Tc = T // p
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    state = RA.init_state(q[:, :, -Tc:])
    state = RA.ring_step(state, q[:, :, -Tc:], k[:, :, :Tc], v[:, :, :Tc], valid[:, :Tc],
                         p - 1, 0)
    torch.cuda.synchronize()
    step_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    del state, got, want, q, k, v
    print(f"ring [{card}]: the ring steps composed over {p} chunks of {Tc} at B 1 x T {T}, "
          f"{H} heads / {KV} kv x Dh {Dh}, bf16: max|err| against K1 {err.max().item():.3e} "
          f"(rtol {RING_RTOL}, atol {RING_ATOL}), {ring_s:.3f} s for the {p * p} steps; one "
          f"chunk step peaks at {step_gb:.3f} GB against {4 * H * T * T / 1e9:.1f} GB for one "
          f"f32 [1, {H}, T, T] score block", flush=True)

    mesh = make_mesh(1, 1, 1, device="cuda")
    q, k, v, valid = flash_inputs(TRAIN_B, H, KV, TRAIN_T, TRAIN_T, 128,
                                  np.ones((TRAIN_B, TRAIN_T), np.int32), seed=41)
    want = flash_attention(q, k, v, valid)
    got = RA.ring_attention(q, k, v, valid, group=(mesh, "model"))
    torch.cuda.synchronize()
    err_b = (got.float() - want.float()).abs()
    check(bool(torch.isfinite(got).all())
          and bool((err_b <= RING_ATOL + RING_RTOL * want.float().abs()).all()),
          f"ring: ring_attention on one rank differs from K1, max err {err_b.max().item()}")
    print(f"ring [{card}]: ring_attention on the mesh's model group (1 rank, NCCL) at B "
          f"{TRAIN_B} x T {TRAIN_T}: max|err| against K1 {err_b.max().item():.3e}", flush=True)
    del q, k, v, got, want
    _set_launch_counts(saved)

    cfg = UniMoEAudioConfig(text_config=dataclasses.replace(
        TextMoEConfig(), num_hidden_layers=MESH_LAYERS), vision_config=None)
    runs = {}
    for axis in ("model", "data", "expert"):
        tcfg = TrainerConfig(learning_rate=1e-4, warmup_steps=0, total_steps=100, log_every=1,
                             ring_axis=axis)
        tr = Trainer(cfg, init_model_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda"),
                     tcfg, mesh=mesh, device="cuda")
        _zero_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        hist, _, marks = _fit_marked(tr, probe_batch(cfg), MESH_TRAIN_STEPS)
        launches = _launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        tp = tr.plan.model
        del tr
        torch.cuda.empty_cache()
        loss_rel = max(abs(a["loss"] - b["loss"]) / abs(a["loss"])
                       for a, b in zip(plain_hist, hist))
        check(loss_rel <= TRAIN_LOSS_REL and not any(launches.values())
              and tp == (axis != "model"),
              f"ring training over {axis}: loss relative {loss_rel}, tensor parallelism "
              f"{tp}, launches {launches}")
        print(f"ring training [{card}]: Trainer(mesh=1 x 1 x 1, ring_axis={axis!r}), tensor "
              f"parallelism {'on' if tp else 'off'}, the flagship cut to {MESH_LAYERS} layers, "
              f"bf16, B {TRAIN_B} x T {TRAIN_T}, {MESH_TRAIN_STEPS} steps: losses "
              f"{[round(h['loss'], 5) for h in hist]} vs mesh-less "
              f"{[round(h['loss'], 5) for h in plain_hist]} (relative {loss_rel:.2e}, limit "
              f"{TRAIN_LOSS_REL}); step seconds {[round(x, 4) for x in _durations(marks)]}; "
              f"peak {peak_gb:.2f} GB; no kernel of the table launched", flush=True)
        runs[axis] = launches
    return runs


def run_pipeline(card: str) -> dict:
    """`pipeline_forward` on the mesh's model group (one stage, NCCL) with
    PIPE_MICRO microbatches of the train probe's batch, the flagship cut to
    MESH_LAYERS layers in bf16, against `text_model_forward(use_flash=
    False)`: the hidden states bit for bit against it on each microbatch;
    against it on the whole batch the hidden states within
    PIPE_HIDDEN_REL_L2, the layers' and the final norm's gradients of
    sum(h · w) (w random) within PIPE_GRAD_REL_L2.  Returns the pipeline
    run's launch counts (none of the table: its attention is einsum
    arithmetic, as in the JAX package)."""
    import dataclasses

    import torch
    from unimoe_audio_torch.config import TextMoEConfig, UniMoEAudioConfig
    from unimoe_audio_torch.models.model import (calculate_input_embedding, init_model_params,
                                                 text_model_forward)
    from unimoe_audio_torch.parallel.mesh import make_mesh
    from unimoe_audio_torch.parallel.pipeline import pipeline_forward

    cfg = UniMoEAudioConfig(text_config=dataclasses.replace(
        TextMoEConfig(), num_hidden_layers=MESH_LAYERS), vision_config=None)
    tc = cfg.text_config
    params = init_model_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    batch = probe_batch(cfg)
    with torch.no_grad():
        x = calculate_input_embedding(
            params, torch.as_tensor(batch["input_ids"], device="cuda"),
            torch.as_tensor(batch["codec_input_ids"], device="cuda"),
            cfg.codec_placeholder_value)
    pos = torch.arange(TRAIN_T, device="cuda")[None, None].expand(3, TRAIN_B, TRAIN_T)
    w = torch.randn(x.shape, generator=torch.Generator(device="cuda").manual_seed(42),
                    device="cuda").to(x.dtype)
    leaves = [t.requires_grad_() for t in _leaves(params["layers"])] + [params["norm"]]
    params["norm"].requires_grad_()
    h0 = text_model_forward(params, x, pos, tc, use_flash=False).last_hidden_state
    g0 = torch.autograd.grad((h0.float() * w.float()).sum(), leaves)
    mesh = make_mesh(1, 1, 1, device="cuda")
    _zero_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h1 = pipeline_forward(params["layers"], params["norm"], x, pos, tc, (mesh, "model"),
                          n_micro=PIPE_MICRO)
    g1 = torch.autograd.grad((h1.float() * w.float()).sum(), leaves)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _launch_counts()
    mb = TRAIN_B // PIPE_MICRO
    with torch.no_grad():
        per_micro = torch.cat([text_model_forward(
            params, x[i:i + mb], pos[:, i:i + mb], tc, use_flash=False).last_hidden_state
            for i in range(0, TRAIN_B, mb)])
    check(torch.equal(h1, per_micro), f"pipeline: the hidden states differ from the "
          f"microbatches' own forwards, max {(h1.float() - per_micro.float()).abs().max().item()}")
    h_rel = _rel(h1.float(), h0.float())
    g_rel = (sum(float(torch.linalg.vector_norm((a.float() - b.float()))) ** 2
                 for a, b in zip(g1, g0))
             / sum(float(torch.linalg.vector_norm(b.float())) ** 2 for b in g0)) ** 0.5
    check(bool(torch.isfinite(h1).all()) and h_rel <= PIPE_HIDDEN_REL_L2
          and g_rel <= PIPE_GRAD_REL_L2 and not any(launches.values()),
          f"pipeline: hidden relative L2 {h_rel}, gradients {g_rel}, launches {launches}")
    print(f"pipeline [{card}]: pipeline_forward, 1 stage (NCCL) x {PIPE_MICRO} microbatches, "
          f"the flagship cut to {MESH_LAYERS} layers, bf16, B {TRAIN_B} x T {TRAIN_T}: hidden "
          f"states equal to each microbatch's text_model_forward(use_flash=False) bit for "
          f"bit; against one forward of the whole batch relative L2 {h_rel:.3e} (limit "
          f"{PIPE_HIDDEN_REL_L2}), gradients of the layers and the final norm {g_rel:.3e} "
          f"(limit {PIPE_GRAD_REL_L2}); forward and backward {secs:.3f} s; no kernel of the "
          f"table launched", flush=True)
    del params, h0, h1, g0, g1, per_micro
    torch.cuda.empty_cache()
    return launches


def check_timeit_in_jit(card: str) -> None:
    """`utils.profiling.timeit_in_jit` (a CUDA graph of the calls, timed by
    events) against `graph_ms` (the same, each call after an L2 flush,
    less the flushes) on one K1 launch at the training shape: within
    TIMEIT_VS_GRAPH.  The launch counts are left as they were."""
    from unimoe_audio_torch.ops.flash_attention import flash_attention
    from unimoe_audio_torch.utils.profiling import timeit_in_jit

    saved = _launch_counts()
    q, k, v, valid = flash_inputs(TRAIN_B, 16, 2, TRAIN_T, TRAIN_T, 128,
                                  np.ones((TRAIN_B, TRAIN_T), np.int32), seed=9)
    jit_ms = timeit_in_jit(flash_attention, q, k, v, valid, iters=20) * 1e3
    g_ms = graph_ms(lambda: flash_attention(q, k, v, valid), 20)
    _set_launch_counts(saved)
    check(g_ms is not None and abs(jit_ms - g_ms) <= TIMEIT_VS_GRAPH * g_ms,
          f"timeit_in_jit {jit_ms} ms vs graph_ms {g_ms} ms on K1")
    print(f"profiling [{card}]: K1 at B {TRAIN_B} x 16 heads x T {TRAIN_T} x Dh 128, bf16: "
          f"timeit_in_jit {jit_ms:.4f} ms, graph_ms {g_ms:.4f} ms (limit {TIMEIT_VS_GRAPH:.0%} "
          f"apart)", flush=True)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from unimoe_audio_torch.api import set_matmul_precision
    from unimoe_audio_torch.ops import cuda_build

    set_matmul_precision()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t_start = time.perf_counter()

    def stamp(phase: str) -> None:
        print(f"time: {phase} done at {time.perf_counter() - t_start:.1f} s", flush=True)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:     # one nvcc per source
        list(pool.map(cuda_build.load, KERNEL_SOURCES))
    print(f"build: {', '.join(KERNEL_SOURCES)} built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for src in KERNEL_SOURCES:
        for line in cuda_build.build_logs[src].splitlines():
            if "registers" in line or "spill" in line or "Function properties" in line:
                print(f"build: {src}: {line.strip()}", flush=True)

    check_flash(8, 16, 2, 128, 128, 128, (0,) * 8, seed=0)
    check_flash(8, 16, 2, 192, 192, 128, (0, 150, 3, 191, 64, 0, 100, 20), seed=1)
    check_flash(8, 16, 2, 128, 128, 128, (111, 40, 111, 0, 111, 70, 111, 5), seed=2)
    check_flash(2, 16, 2, 100, 160, 64, (7, 0), seed=3)
    # K1's tile edges (128 query rows, 128 keys): one row and one key past a
    # tile; one query tile over three key tiles, the last ragged (S > T);
    # Dh 64 with S > T; non-causal.
    check_flash(2, 16, 2, 129, 129, 128, (0, 5), seed=4)
    check_flash(2, 16, 2, 64, 300, 128, (7, 0), seed=6)
    check_flash(2, 16, 2, 100, 300, 64, (5, 0), seed=7)
    check_flash(2, 16, 2, 192, 192, 128, (0, 5), seed=8, causal=False)
    check_small_prefill()
    stamp("build and small checks")

    # The serving path runs before any training-shape work, on an emptied
    # allocator, so its timings do not follow the multi-GB plain versions.
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out_dir:
        model, prompts, t2m_launches = run_slice(card, out_dir)
        stamp("dense text_to_music and its repeated prefills")
        t2m_mask = model._tokenize(prompts)[1]
        fwd_rec = time_flash(model.config.text_config, t2m_mask, t2m_launches, card, "T2M")
        stamp("K1 timing at the T2M prefill shape")
        tts_launches, tts_rec = run_tts(model, card, out_dir)
        stamp("TTS, K1 at its prefill shape and the reference checks")
        stream_launches = run_stream(model, card)
        stamp("streaming T2M")
        vt2m_launches, vt2m_rec = run_vt2m(model, card, out_dir)
        stamp("VT2M, K1 at its prefill shape and the reference checks")
        serving_launches, admit_rec = run_serving_apps(model, card, out_dir, stamp)
        gmm_t2m_launches = run_gmm_serving(model, prompts, card, out_dir)
        stamp("gmm serving")
        export_launches = run_export(model, prompts, card)
        stamp("the HF export at 4 layers and its reload")
        mesh_serve_launches = run_mesh_serving(model, prompts, card)
        stamp("serving and an ep forward on the 1 x 1 x 1 mesh")
    del model
    torch.cuda.empty_cache()
    quant_launches = run_quantized_serving(card, stamp)
    stamp("serving modes at the tiny config")

    # K1 at the training shape, then K2 and K3 there and at ragged T, dead
    # rows, S > T, non-causal and Dh 64.
    fwd_train_err = check_flash(TRAIN_B, 16, 2, TRAIN_T, TRAIN_T, 128, (0,) * TRAIN_B, seed=9)
    bwd_errs = check_flash_bwd(TRAIN_B, 16, 2, TRAIN_T, TRAIN_T, 128, (0,) * TRAIN_B, True,
                               seed=10)
    check_flash_bwd(4, 16, 2, 200, 200, 128, (0, 150, 3, 199), True, seed=11)
    check_flash_bwd(4, 16, 2, 128, 128, 128, (111, 40, 127, 0), True, seed=12)
    check_flash_bwd(2, 16, 2, 100, 160, 128, (7, 0), True, seed=13)
    check_flash_bwd(2, 16, 2, 192, 192, 128, (0, 5), False, seed=14)
    check_flash_bwd(2, 16, 2, 200, 200, 64, (30, 0), True, seed=15)
    # The tiles' edges (K2: 128 query rows, 64-key tiles; K3: 128 keys,
    # 64-row query tiles): one row and one key past a tile; one query tile
    # over five key tiles; Dh 64 with S > T; S - T = 90, so K3's key tiles
    # 1 and 2 start their query range in mid-tile (rows 38 and 166); T > S,
    # whose first 100 rows attend no key; H = KV (no GQA sum).
    check_flash_bwd(2, 16, 2, 129, 129, 128, (0, 5), True, seed=16)
    check_flash_bwd(2, 16, 2, 64, 300, 128, (7, 0), True, seed=17)
    check_flash_bwd(2, 16, 2, 100, 300, 64, (5, 0), True, seed=18)
    check_flash_bwd(2, 16, 2, 200, 290, 128, (3, 0), True, seed=19)
    check_flash_bwd(2, 16, 2, 300, 200, 128, (0, 9), True, seed=20)
    check_flash_bwd(2, 4, 4, 256, 256, 128, (0, 33), True, seed=21)
    grouped_errs = check_grouped_all()
    check_small_training()
    check_small_vision_peft_training()
    torch.cuda.empty_cache()
    stamp("training-shape kernel checks and the small training checks")
    # The f32 kernels at the same shapes: the prefill and training shapes,
    # tile edges (K1 and K2: 128 query rows, 32-key tiles; K3: 64 keys,
    # 64-row query tiles), pads, S > T, T > S, non-causal, Dh 64, H = KV.
    # K1 also one row and one key past two row tiles (257), one row tile
    # over ten key tiles with the last ragged (S 300), a second row tile of
    # one row over 193 keys at Dh 64, GQA 8:1 over one kv head and H = KV;
    # each K1 check launches it twice for equal bits.  K2 and K3 also one
    # row and one key past their tiles (129), S - T = 90 (K3's key tiles
    # start their query range mid-tile), T > S with dead rows at Dh 64, GQA
    # 8:1 over one kv head and 1:1 non-causal.
    f32 = torch.float32
    f32_errs = {"fwd": max(
        check_flash(8, 16, 2, 128, 128, 128, (0,) * 8, seed=0, dtype=f32),
        check_flash(8, 16, 2, 192, 192, 128, (0, 150, 3, 191, 64, 0, 100, 20), seed=1, dtype=f32),
        check_flash(2, 16, 2, 100, 160, 64, (7, 0), seed=3, dtype=f32),
        check_flash(2, 16, 2, 129, 129, 128, (0, 5), seed=4, dtype=f32),
        check_flash(2, 16, 2, 64, 300, 128, (7, 0), seed=6, dtype=f32),
        check_flash(2, 16, 2, 192, 192, 128, (0, 5), seed=8, causal=False, dtype=f32),
        check_flash(2, 16, 2, 257, 257, 128, (0, 9), seed=30, dtype=f32),
        check_flash(2, 16, 2, 128, 300, 128, (5, 0), seed=31, dtype=f32),
        check_flash(2, 16, 2, 129, 193, 64, (0, 4), seed=32, dtype=f32),
        check_flash(2, 8, 1, 129, 129, 128, (0, 7), seed=33, dtype=f32),
        check_flash(2, 4, 4, 200, 200, 128, (3, 0), seed=34, dtype=f32),
        check_flash(TRAIN_B, 16, 2, TRAIN_T, TRAIN_T, 128, (0,) * TRAIN_B, seed=9, dtype=f32))}
    f32_bwd = [check_flash_bwd(*a, dtype=f32) for a in (
        (TRAIN_B, 16, 2, TRAIN_T, TRAIN_T, 128, (0,) * TRAIN_B, True, 10),
        (4, 16, 2, 200, 200, 128, (0, 150, 3, 199), True, 11),
        (2, 16, 2, 192, 192, 128, (0, 5), False, 14),
        (2, 16, 2, 65, 65, 128, (0, 5), True, 16),
        (2, 16, 2, 100, 145, 64, (5, 0), True, 18),
        (2, 16, 2, 300, 200, 128, (0, 9), True, 20),
        (2, 4, 4, 256, 256, 128, (0, 33), True, 21),
        (2, 16, 2, 129, 129, 128, (0, 5), True, 22),
        (2, 16, 2, 64, 65, 128, (7, 0), True, 23),
        (2, 16, 2, 200, 290, 128, (3, 0), True, 24),
        (2, 16, 2, 160, 97, 64, (3, 0), True, 25),
        (2, 8, 1, 129, 129, 64, (0, 7), True, 26),
        (2, 2, 2, 65, 130, 128, (0, 3), False, 27))]
    f32_errs.update({lab: max(e[lab] for e in f32_bwd) for lab in ("dq", "dk", "dv")})
    torch.cuda.empty_cache()
    stamp("f32 kernel checks")

    train_launches, dense_losses = run_train_slice(card)
    bwd_recs, fwd_train = time_flash_bwd(train_launches, bwd_errs, card)
    torch.cuda.empty_cache()
    stamp("dense training")
    gmm_train_launches, _ = run_train_slice(card, "gmm", dense_losses)
    torch.cuda.empty_cache()
    stamp("gmm training")
    mesh_train_launches, mesh_plain_hist = run_mesh_training(card)
    stamp("mesh training at world size 1")
    ring_launches = run_ring(card, mesh_plain_hist)
    stamp("ring attention: composed at T 16384, on one rank, and the ring trainers over the "
          "model, data and expert axes")
    pipeline_launches = run_pipeline(card)
    stamp("the pipeline at one stage")
    check_timeit_in_jit(card)
    stamp("timeit_in_jit against graph_ms")
    core_launches = run_train_core(card)
    stamp("the training core (resume, accumulation, mixer, export)")
    vision_train_launches = run_train_vision(card)
    stamp("vision training")
    peft_launches = run_peft(card)
    stamp("PEFT, surgery and resharding")
    check_small_offload_stream(card)
    stamp("the offload and stream trainers against Trainer, each other and the CPU")
    offload_launches = run_train_offload(card)
    stamp("OffloadTrainer at 36 layers")
    train_stream_launches = run_train_stream(card)
    stamp("StreamTrainer at 36 and 4 layers")
    check_sliding_window(card)
    stamp("the sliding-window witness")
    f32_recs = time_flash_f32(t2m_mask, f32_errs, card)
    torch.cuda.empty_cache()
    stamp("f32 kernel timing")
    grouped_recs = time_grouped(grouped_errs, card)
    stamp("grouped GEMM timing")
    # Launches by path (each run counted from 0) and summed over the paths;
    # K1's error is the larger of the checks at the two paths' shapes.
    paths = {"t2m": t2m_launches, "tts": tts_launches, "t2m_stream": stream_launches,
             "vt2m": vt2m_launches, **serving_launches, "t2m_gmm": gmm_t2m_launches,
             **quant_launches,
             "train": train_launches, "train_gmm": gmm_train_launches, **core_launches,
             "train_vision": vision_train_launches, "train_peft": peft_launches,
             "train_offload": offload_launches, "train_stream": train_stream_launches,
             "export": export_launches, "mesh_serve": mesh_serve_launches,
             "mesh_train": mesh_train_launches, "train_ring": ring_launches["model"],
             "train_ring_data": ring_launches["data"],
             "train_ring_expert": ring_launches["expert"], "pipeline": pipeline_launches}
    for rec in (fwd_rec, *bwd_recs, *f32_recs, *grouped_recs):
        rec["launches_by_path"] = {p: n[rec["name"]] for p, n in paths.items()}
        rec["launches"] = sum(rec["launches_by_path"].values())
        if rec["name"].startswith("flash_attention_bwd_dkv"):    # and its GQA sum
            reduce = rec["name"] + "_reduce"
            rec["reduce_launches_by_path"] = {p: n[reduce] for p, n in paths.items()}
        if rec["name"] == "grouped_gemm_gmm":        # K4 by tile configuration and path
            rec["launches_by_config"] = {
                c: {p: n[f"grouped_gemm_gmm_{c}"] for p, n in paths.items()}
                for c in ("small", "large")}
            rec["t2m_gmm_layers"] = GMM_SERVING_LAYERS          # the gmm serving run's depth
    for path in ("train_vision", "train_peft", "train_offload", "train_stream", "mesh_train"):
        check(all(paths[path][k] > 0 for k in ("flash_attention_fwd", "flash_attention_bwd_dq",
                                                  "flash_attention_bwd_dkv")),
              f"K1, K2 or K3 not launched on the {path} path: {paths[path]}")
    check(all(r["launches"] > 0 for r in f32_recs),
          f"an f32 kernel was not launched on any path: {[r['name'] for r in f32_recs]}")
    check(all(r["launches"] > 0 for r in grouped_recs),
          f"a grouped kernel was not launched on any path: {[r['name'] for r in grouped_recs]}")
    fwd_rec["max_abs_err_by_path"] = {"t2m": fwd_rec["max_abs_err"],
                                      "tts": tts_rec["max_abs_err"],
                                      "vt2m": vt2m_rec["max_abs_err"],
                                      "continuous": admit_rec["max_abs_err"],
                                      "train": fwd_train_err}
    fwd_rec["max_abs_err"] = max(fwd_rec["max_abs_err_by_path"].values())
    for path, r in (("tts", tts_rec), ("vt2m", vt2m_rec), ("continuous", admit_rec)):
        fwd_rec[f"{path}_shape"] = {k: r[k] for k in (
            "ms", "device_ms_graph", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library_device_ms_graph", "max_abs_err")}
    fwd_train["launches_by_path"] = {p: paths[p]["flash_attention_fwd"]
                                     for p in ("train", "train_gmm", "mesh_train", "train_ring",
                                               "train_ring_data", "train_ring_expert")}
    fwd_rec["train_shape"] = fwd_train

    print(json.dumps({"kernels": [fwd_rec, *bwd_recs, *f32_recs, *grouped_recs]}), flush=True)
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
