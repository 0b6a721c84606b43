#!/usr/bin/env python3
"""Training entry of the port — counterpart of `unimoe_audio_tpu/train/cli.py`:
the same arguments, training one model on one card with `Trainer`.

    python -m unimoe_audio_torch.train.cli --model_name_or_path MODEL_DIR \\
        --data_path ARROW_DIR --output_dir OUT [--initialize --moe_copy all] \\
        [--peft_mode lora|prefix|ptuning|prompt] [--cpu]

MODEL_DIR holds config.json and, unless the weights are to be random,
model.jax.pkl (dense with --initialize, which seeds the experts from it,
`train/surgery.py`).  `--param_offload [--moment_dtype int8]` trains with
`StreamTrainer` (`train/stream.py`): the layers' weights and Adam moments
in host memory, streamed one layer at a time through the card (the full
36-layer flagship on one card), lm_head trained; it resumes from
OUT/stream_ckpt, counts applied steps (`--gradient_accumulation_steps`
micro-batches make one) and refuses PEFT, gate-only training and image
samples.  ARROW_DIR is a `datasets.save_to_disk` directory of
{"conversations": [...], "image_path": ...} rows (reading it needs the
`datasets` package, and image rows PIL).  The run writes
OUT/metrics.jsonl, checkpoints under OUT/checkpoints and OUT/train_done.json.

Runs on the first CUDA card and raises without one; `--cpu` trains on the
CPU.  On several ranks (one process each: `torchrun` with `--multihost`,
or `--coordinator-address HOST:PORT --num-processes N --process-id I`) it
trains on the (N / (ep·tp), `--ep_size`, `--tp_size`) mesh
(`Trainer(mesh=...)`), `--fsdp` keeping the optimizer state on each data
rank's slice; rank 0 writes metrics.jsonl and train_done.json, each rank
its checkpoints (OUT/checkpoints/rank{r}):

    torchrun --nproc-per-node 2 -m unimoe_audio_torch.train.cli --multihost \
        --ep_size 2 --fsdp --model_name_or_path MODEL_DIR --data_path ARROW_DIR
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pickle
import sys

from unimoe_audio_torch.parallel.multihost import add_multihost_args, maybe_initialize_multihost


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="UniMoE-Audio trainer (PyTorch port)")
    # Model arguments
    p.add_argument("--model_name_or_path", required=True)
    p.add_argument("--initialize", action="store_true",
                   help="run dense→MoE surgery on a dense checkpoint")
    p.add_argument("--moe_copy", choices=["all", "single", "none"], default="all")
    p.add_argument("--mlp_dynamic_expert_num", type=int, default=4)
    p.add_argument("--mlp_dynamic_null_expert_num", type=int, default=1)
    p.add_argument("--mlp_fixed_expert_num", type=int, default=2)
    p.add_argument("--mlp_dynamic_top_p", type=float, default=0.7)
    p.add_argument("--mlp_dynamic_top_k", type=int, default=0)
    p.add_argument("--dynamic_mlp_size_factor", type=int, default=4)
    p.add_argument("--fixed_mlp_size_factor", type=int, default=8)
    p.add_argument("--token_drop", action="store_true")
    p.add_argument("--drop_policy", choices=["probs", "position"], default="probs")
    p.add_argument("--capacity_factor", type=float, default=3.0)
    p.add_argument("--min_capacity", type=int, default=8)
    p.add_argument("--ep_size", type=int, default=1)
    p.add_argument("--tp_size", type=int, default=1)
    p.add_argument("--param_offload", action="store_true",
                   help="layer params and Adam moments in host memory, streamed one layer "
                        "at a time through the card (train/stream.py)")
    p.add_argument("--moment_dtype", choices=["float32", "int8"], default="float32",
                   help="(with --param_offload) Adam-moment storage: int8 = blockwise "
                        "log-quantized codes (train/qmoment.py), 4x less host traffic")
    p.add_argument("--fsdp", action="store_true",
                   help="keep each large leaf's optimizer state and update on one data rank's "
                        "slice (ZeRO-2 over the data axis)")
    p.add_argument("--only_gate_training", action="store_true")
    # Data arguments
    p.add_argument("--data_path", required=True)
    p.add_argument("--image_root", default=None)
    p.add_argument("--data_sample", type=int, default=None)
    p.add_argument("--model_max_length", type=int, default=4096)
    # Training arguments
    p.add_argument("--output_dir", default="./output")
    p.add_argument("--num_train_epochs", type=float, default=1.0)
    p.add_argument("--per_device_train_batch_size", type=int, default=2)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1,
                   help="micro-batches per optimizer update")
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--warmup_ratio", type=float, default=0.03)
    p.add_argument("--lr_scheduler_type", default="cosine")
    p.add_argument("--l_aux_weight", type=float, default=0.025)
    p.add_argument("--min_l_aux_weight", type=float, default=0.001)
    p.add_argument("--l_aux_weight_decay_steps", type=int, default=10000)
    p.add_argument("--aux_balance_weight", type=float, default=10.0)
    p.add_argument("--save_steps", type=int, default=500)
    p.add_argument("--logging_steps", type=int, default=10)
    p.add_argument("--eval_ratio", type=float, default=0.0,
                   help="fraction of the dataset held out for validation (tail split; 0 "
                        "disables), evaluated every --eval_steps")
    p.add_argument("--eval_steps", type=int, default=0,
                   help="validate every N steps (0 = only at the end when --eval_ratio > 0)")
    p.add_argument("--gradient_checkpointing", action="store_true", default=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max_steps", type=int, default=None)
    add_multihost_args(p)
    p.add_argument("--peft_mode", choices=["lora", "prefix", "ptuning", "prompt"], default=None,
                   help="parameter-efficient finetuning: adapters train, the base is frozen")
    p.add_argument("--lora_r", type=int, default=16)
    p.add_argument("--lora_alpha", type=float, default=32.0)
    p.add_argument("--cpu", action="store_true", help="train on the CPU instead of the card")
    return p


def train_streamed(args, cfg, params, device, batches, eval_batches, total_steps: int,
                   gas: int, ckpt_dir: str, resume: bool) -> int:
    """--param_offload: `StreamTrainer` with lm_head trained, resumed from
    ckpt_dir when it holds a checkpoint; gas micro-batches make one applied
    step (`cli.py:235-300` in the JAX package)."""
    from unimoe_audio_torch.train.step import make_lr_schedule
    from unimoe_audio_torch.train.stream import StreamTrainer
    from unimoe_audio_torch.train.trainer import MetricsLogger

    if args.peft_mode or args.only_gate_training:
        raise SystemExit("--param_offload is full-parameter training only; PEFT and gate-only "
                         "curricula run through the standard trainer")
    image_msg = ("--param_offload does not support image samples; train vision data through "
                 "the standard trainer")
    if eval_batches is not None and any("pixel_values" in b for b in eval_batches):
        raise SystemExit(image_msg)
    warmup = max(1, int(total_steps * args.warmup_ratio))
    sched = make_lr_schedule(args.learning_rate, warmup, total_steps, args.lr_scheduler_type)
    trainer = StreamTrainer(cfg, params, seed=args.seed, restore_dir=ckpt_dir if resume else None,
                            learning_rate=sched, weight_decay=args.weight_decay,
                            train_lm_head=True, moment_dtype=args.moment_dtype, device=device)
    del params
    if resume:
        print(f"resumed stream checkpoint at step {trainer.step}")
    os.makedirs(args.output_dir, exist_ok=True)
    logger = MetricsLogger(os.path.join(args.output_dir, "metrics.jsonl"))
    try:
        micro = []
        for batch in batches:
            if trainer.step >= total_steps:
                break
            if "pixel_values" in batch:
                raise SystemExit(image_msg)
            micro.append(batch)
            if len(micro) < gas:
                continue
            m = trainer.train_step(micro, args.seed)
            micro = []
            if trainer.step % args.logging_steps == 0 or m.get("skipped"):
                logger.log(trainer.step, m)
            if args.eval_steps and eval_batches is not None and trainer.step > 0 \
                    and trainer.step % args.eval_steps == 0:
                logger.log(trainer.step, trainer.evaluate(eval_batches))
            if args.save_steps and trainer.step > 0 and trainer.step % args.save_steps == 0:
                trainer.save(ckpt_dir)
        if micro and trainer.step < total_steps:
            # The trailing partial group (the step divides by its length).
            logger.log(trainer.step, trainer.train_step(micro, args.seed))
        if eval_batches is not None:
            logger.log(trainer.step, trainer.evaluate(eval_batches))
        trainer.save(ckpt_dir)
        with open(os.path.join(args.output_dir, "train_done.json"), "w") as f:
            json.dump({"steps": int(trainer.step)}, f)
    finally:
        logger.close()
        trainer.close()
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    maybe_initialize_multihost(args, cpu=args.cpu)

    import numpy as np
    import torch
    import torch.distributed as dist

    from unimoe_audio_torch.api import resolve_device
    from unimoe_audio_torch.config import UniMoEAudioConfig
    from unimoe_audio_torch.core.bridge import params_from_jax
    from unimoe_audio_torch.models.model import init_model_params
    from unimoe_audio_torch.parallel.comm import is_writer
    from unimoe_audio_torch.parallel.mesh import default_mesh_shape, make_mesh
    from unimoe_audio_torch.tokenizer import SimpleTokenizer
    from unimoe_audio_torch.train.data import Collator, ConversationDataset, prefetch
    from unimoe_audio_torch.train.surgery import moeify_dense_params
    from unimoe_audio_torch.train.trainer import MetricsLogger, Trainer, TrainerConfig

    device = torch.device("cpu") if args.cpu else resolve_device()

    # --- config and parameters ------------------------------------------
    cfg = UniMoEAudioConfig.from_json(os.path.join(args.model_name_or_path, "config.json"))
    tc = dataclasses.replace(
        cfg.text_config,
        mlp_dynamic_expert_num=args.mlp_dynamic_expert_num,
        mlp_dynamic_null_expert_num=args.mlp_dynamic_null_expert_num,
        mlp_fixed_expert_num=args.mlp_fixed_expert_num,
        mlp_dynamic_top_p=args.mlp_dynamic_top_p,
        mlp_dynamic_top_k=args.mlp_dynamic_top_k,
        dynamic_intermediate_size=cfg.text_config.intermediate_size // args.dynamic_mlp_size_factor,
        shared_intermediate_size=cfg.text_config.intermediate_size // args.fixed_mlp_size_factor,
        token_drop=args.token_drop,
        drop_policy=args.drop_policy,
        capacity_factor=args.capacity_factor,
        min_capacity=args.min_capacity,
        l_aux_weight=args.l_aux_weight,
        min_l_aux_weight=args.min_l_aux_weight,
        l_aux_weight_decay_steps=args.l_aux_weight_decay_steps,
        ep_size=args.ep_size,
    ) if args.initialize else cfg.text_config
    cfg = dataclasses.replace(cfg, text_config=tc)

    blob_path = os.path.join(args.model_name_or_path, "model.jax.pkl")
    stream_ckpt = os.path.join(args.output_dir, "stream_ckpt")
    resume_stream = args.param_offload and os.path.isfile(os.path.join(stream_ckpt, "meta.json"))
    params = None
    if resume_stream:
        pass                                  # the stream checkpoint holds the weights
    elif os.path.isfile(blob_path):
        with open(blob_path, "rb") as f:
            blob = pickle.load(f)
        # The stream trainer copies the weights into host memory layer by
        # layer: they need not pass through the card first.
        params = params_from_jax(blob["params"], cfg,
                                 torch.device("cpu") if args.param_offload else device)
        if args.initialize:
            params = moeify_dense_params(params, tc, moe_copy=args.moe_copy)
    else:
        print("[warning] no model.jax.pkl found — random init (development run)")
        if not args.param_offload:         # the stream trainer draws its own, layer by layer
            params = init_model_params(cfg, seed=args.seed, device=device,
                                       with_vision=cfg.vision_config is not None)

    # --- data -------------------------------------------------------------
    try:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(args.model_name_or_path)
    except Exception:
        print("[warning] no HF tokenizer assets — using the development whitespace tokenizer")
        tokenizer = SimpleTokenizer(
            vocab_size=cfg.text_config.vocab_size,
            # The vision specials map to the config's ids, so that the
            # mRoPE spans resolve (get_rope_index keys on them).
            special={"<|vision_start|>": cfg.vision_start_token_id,
                     "<|vision_end|>": cfg.vision_end_token_id,
                     "<|image_pad|>": cfg.image_token_id,
                     "<|video_pad|>": cfg.video_token_id})
    dataset = ConversationDataset(
        args.data_path, tokenizer, image_token_index=cfg.image_token_id,
        model_max_length=args.model_max_length, data_sample=args.data_sample,
        image_root=args.image_root, vision_config=cfg.vision_config)
    collator = Collator(pad_token_id=tokenizer.pad_token_id or 0,
                        aux_balance_weight=args.aux_balance_weight,
                        model_max_length=args.model_max_length)

    # --- train / eval split (tail hold-out) --------------------------------
    bs = args.per_device_train_batch_size
    n_eval = 0
    if args.eval_ratio > 0:
        n_eval = max(1, int(len(dataset) * args.eval_ratio))
        n_eval = min(n_eval, max(0, len(dataset) - bs))       # keep one train batch
    n_train = len(dataset) - n_eval
    eval_batches = None
    if n_eval:
        ebs = min(bs, n_eval)
        eval_batches = [collator([dataset[int(j)] for j in range(i, i + ebs)])
                        for i in range(n_train, len(dataset) - ebs + 1, ebs)]
        print(f"eval hold-out: {n_eval} samples → {len(eval_batches)} batches")

    gas = max(1, args.gradient_accumulation_steps)
    # The stream trainer counts applied steps; Trainer counts micro-steps.
    steps_per_epoch = max(1, n_train // (bs * (gas if args.param_offload else 1)))
    total_steps = args.max_steps or int(steps_per_epoch * args.num_train_epochs)

    def batches():
        rng = np.random.default_rng(args.seed)
        for _ in range(int(args.num_train_epochs)):
            order = rng.permutation(n_train)
            for i in range(0, len(order) - bs + 1, bs):
                yield collator([dataset[int(j)] for j in order[i:i + bs]])

    if args.param_offload:
        return train_streamed(args, cfg, params, device, prefetch(batches()), eval_batches,
                              total_steps, gas, stream_ckpt, resume_stream)

    # --- mesh ---------------------------------------------------------------
    n_dev = dist.get_world_size() if dist.is_initialized() else 1
    mesh_shape = default_mesh_shape(n_dev, args.ep_size, args.tp_size)
    mesh = None
    if n_dev > 1 or args.fsdp:
        mesh = make_mesh(*mesh_shape, device=device.type)
    print(f"mesh (data, expert, model) = {mesh_shape} over {n_dev} devices"
          + (" [fsdp]" if args.fsdp else ""))

    # --- train --------------------------------------------------------------
    trainable = None
    if args.only_gate_training:
        trainable = r"moe/gate"
    if args.peft_mode:
        if args.peft_mode == "lora":
            from unimoe_audio_torch.train.lora import add_lora

            params = add_lora(params, args.seed + 1, rank=args.lora_r, alpha=args.lora_alpha)
            trainable = r"lora"
        else:
            from unimoe_audio_torch.train import peft as peft_mod

            init = {"prefix": peft_mod.init_prefix_tuning, "ptuning": peft_mod.init_p_tuning,
                    "prompt": peft_mod.init_prompt_tuning}[args.peft_mode]
            gen = torch.Generator(device=device)
            gen.manual_seed(args.seed + 1)
            params["peft"] = init(gen, cfg, device=device)
            trainable = r"peft"
    tcfg = TrainerConfig(
        trainable_pattern=trainable,
        learning_rate=args.learning_rate,
        weight_decay=args.weight_decay,
        warmup_steps=max(1, int(total_steps * args.warmup_ratio)),
        total_steps=total_steps,
        schedule=args.lr_scheduler_type,
        log_every=args.logging_steps,
        save_every=args.save_steps,
        ckpt_dir=os.path.join(args.output_dir, "checkpoints"),
        remat=args.gradient_checkpointing,
        seed=args.seed,
        grad_accum_steps=gas,
        # 0 with a hold-out still evaluates once at the end of fit().
        eval_every=args.eval_steps or (total_steps if eval_batches else 0),
    )
    os.makedirs(args.output_dir, exist_ok=True)
    logger = MetricsLogger(os.path.join(args.output_dir, "metrics.jsonl") if is_writer()
                           else None)
    trainer = Trainer(cfg, params, tcfg, logger=logger, device=device, mesh=mesh,
                      fsdp=args.fsdp)
    trainer.fit(prefetch(batches()), max_steps=args.max_steps, eval_batches=eval_batches)
    logger.close()
    if is_writer():
        with open(os.path.join(args.output_dir, "train_done.json"), "w") as f:
            json.dump({"steps": int(trainer.state.step)}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
