"""The training CLI of the PyTorch port (`python -m unimoe_audio_torch.train.cli`)
on the CPU (`--cpu`): on the sample arrow dataset with images, from a
`model.jax.pkl` (input jitter off in config.json), its metrics.jsonl losses
and eval losses equal the JAX package's CLI's on the same directory; it runs
`--initialize` (dense→MoE surgery) on a dense model.jax.pkl and
`--peft_mode lora` (only the adapters move); without `--cpu` it asks for a
card; the mesh flags raise NotImplementedError naming their slice.
`--param_offload` (the stream trainer) on a text-only dataset: its
metrics.jsonl losses equal the JAX CLI's with f32 moments, int8 moments and
two micro-batches a step; it resumes from OUT/stream_ckpt; PEFT and image
samples exit as the JAX CLI does."""

import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from examples.make_sample_dataset import build as build_sample_dataset
from unimoe_audio_tpu.config import tiny_test_config
from unimoe_audio_tpu.train import cli as JCLI
from unimoe_audio_torch.core.bridge import params_from_jax, params_to_numpy
from unimoe_audio_torch.core.checkpoint import latest_step
from unimoe_audio_torch.models.model import init_model_params
from unimoe_audio_torch.train import cli as TCLI
from unimoe_audio_torch.train.step import named_leaves

LOSS_RTOL = 1e-5          # tests/test_torch_train.py's


@pytest.fixture(autouse=True)
def _offline(monkeypatch):
    # The CLIs look for an HF tokenizer in the model directory (there is
    # none: they take the development tokenizer); never ask the hub.
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """The sample arrow dataset (5 rows, each with an image of one size, so
    that the JAX trainer compiles one step) and a model
    directory: tiny config with its tower, jitter off, f32 random weights
    (the port's init, in the JAX layout) in model.jax.pkl."""
    root = tmp_path_factory.mktemp("cli")
    data = str(root / "ds")
    build_sample_dataset(data, n=5, with_images=True, every=1)
    cfg = tiny_test_config(with_vision=True, input_jitter_noise=0.0)
    model = str(root / "model")
    os.makedirs(model)
    cfg.save_json(os.path.join(model, "config.json"))
    tree = params_to_numpy(init_model_params(cfg, seed=0, dtype=torch.float32, device="cpu",
                                             with_vision=True))
    with open(os.path.join(model, "model.jax.pkl"), "wb") as f:
        pickle.dump({"params": tree, "config": cfg.to_dict()}, f)
    return cfg, model, data, tree


def _argv(model, data, out, *extra):
    return ["--model_name_or_path", model, "--data_path", data, "--image_root", data + "_images",
            "--output_dir", out, "--per_device_train_batch_size", "2", "--max_steps", "2",
            "--logging_steps", "1", "--save_steps", "0", "--model_max_length", "128",
            "--eval_ratio", "0.25", "--eval_steps", "1", "--learning_rate", "1e-3", *extra]


def _rows(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f.read().splitlines()]


def test_cli_losses_match_jax_cli(dirs, tmp_path, monkeypatch):
    """Both CLIs on the same directories: the same metrics rows (2 steps,
    an eval after each and one at the end), losses within LOSS_RTOL.  The
    JAX CLI sees one of the test harness's 8 virtual CPU devices, as the
    port trains on one card (its mesh is then 1 x 1 x 1)."""
    _, model, data, _ = dirs
    assert TCLI.main(_argv(model, data, str(tmp_path / "t"), "--cpu")) == 0
    one = jax.devices()[:1]
    monkeypatch.setattr(jax, "devices", lambda *a: one)
    assert JCLI.main(_argv(model, data, str(tmp_path / "j"))) == 0
    got, want = _rows(str(tmp_path / "t")), _rows(str(tmp_path / "j"))
    assert [r["step"] for r in got] == [r["step"] for r in want]
    assert sum("eval_loss" in r for r in got) >= 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in ("loss", "codec_loss", "aux_loss", "grad_norm", "eval_loss", "eval_aux_loss"):
            if k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=LOSS_RTOL, err_msg=k)
    with open(tmp_path / "t" / "train_done.json") as f:
        assert json.load(f) == {"steps": 2}
    assert latest_step(str(tmp_path / "t" / "checkpoints")) == 2


def test_cli_initialize_from_dense(dirs, tmp_path):
    """--initialize on a dense model.jax.pkl (layers.mlp of the config's
    intermediate size): the surgery seeds the experts, one step trains."""
    cfg, _, data, base = dirs
    tc = cfg.text_config
    L, D, F = tc.num_hidden_layers, tc.hidden_size, tc.intermediate_size
    rng = np.random.default_rng(0)
    tree = dict(base)
    tree["layers"] = {k: v for k, v in tree["layers"].items() if k != "moe"}
    tree["layers"]["mlp"] = {"gate": rng.normal(size=(L, D, F)).astype(np.float32) * 0.05,
                             "up": rng.normal(size=(L, D, F)).astype(np.float32) * 0.05,
                             "down": rng.normal(size=(L, F, D)).astype(np.float32) * 0.05}
    model = str(tmp_path / "dense")
    os.makedirs(model)
    cfg.save_json(os.path.join(model, "config.json"))
    with open(os.path.join(model, "model.jax.pkl"), "wb") as f:
        pickle.dump({"params": tree, "config": cfg.to_dict()}, f)
    out = str(tmp_path / "out")
    argv = _argv(model, data, out, "--cpu", "--initialize", "--moe_copy", "single",
                 "--mlp_dynamic_expert_num", "2", "--dynamic_mlp_size_factor", "4",
                 "--fixed_mlp_size_factor", "8", "--max_steps", "1", "--eval_ratio", "0")
    assert TCLI.main(argv) == 0
    rows = _rows(out)
    assert len(rows) == 1 and np.isfinite(rows[0]["loss"])


def test_cli_peft_lora(dirs, tmp_path, capsys):
    """--peft_mode lora: the trainer trains only the LoRA leaves (its
    trainable log names them); the checkpoint's base weights equal the
    model.jax.pkl's."""
    cfg, model, data, tree = dirs
    out = str(tmp_path / "out")
    assert TCLI.main(_argv(model, data, out, "--cpu", "--peft_mode", "lora", "--lora_r", "4",
                           "--eval_ratio", "0")) == 0
    assert "lora" in capsys.readouterr().out
    rows = _rows(out)
    assert len(rows) == 2 and all(np.isfinite(r["loss"]) for r in rows)
    step = latest_step(os.path.join(out, "checkpoints"))
    saved = torch.load(os.path.join(out, "checkpoints", str(step), "state.pt"),
                       weights_only=True)
    base = {}
    for name, t in named_leaves(params_from_jax(tree, cfg, "cpu")):
        base.setdefault(name, []).append(t)
    lora_moved = False
    for name, t in zip(saved["names"], saved["params"]):
        if "lora" in name:
            lora_moved |= name.endswith("lora_b") and bool(t.abs().max() > 0)
        else:
            assert torch.equal(t, base[name].pop(0)), name
    assert lora_moved


def test_cli_needs_a_card_without_cpu(dirs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    _, model, data, _ = dirs
    with pytest.raises(RuntimeError, match="cpu"):
        TCLI.main(_argv(model, data, str(tmp_path / "o")))


@pytest.mark.parametrize("flags,slice_name", [
    (["--param_offload"], "offload"), (["--moment_dtype", "int8"], "offload"),
    (["--fsdp"], "parallel"), (["--ep_size", "2"], "parallel"), (["--tp_size", "2"], "parallel"),
    (["--multihost"], "parallel"), (["--coordinator-address", "localhost:1"], "parallel"),
    (["--num-processes", "2"], "parallel"), (["--process-id", "0"], "parallel")])
def test_cli_refuses_unported_flags(flags, slice_name):
    """The mesh and multihost flags raise NotImplementedError naming the
    parallel slice; the offload flags, ported, pass."""
    argv = ["--model_name_or_path", "m", "--data_path", "d", "--cpu", *flags]
    if slice_name == "offload":
        assert TCLI.refuse_unported(TCLI.build_parser().parse_args(argv)) is None
        return
    with pytest.raises(NotImplementedError, match=slice_name):
        TCLI.main(argv)


@pytest.fixture(scope="module")
def text_dirs(tmp_path_factory):
    """A text-only sample dataset (10 rows) and a model directory: the tiny
    config without a tower, input jitter off, f32 weights in model.jax.pkl."""
    root = tmp_path_factory.mktemp("stream_cli")
    data = str(root / "ds")
    build_sample_dataset(data, n=10, with_images=False)
    cfg = tiny_test_config(input_jitter_noise=0.0)
    model = str(root / "model")
    os.makedirs(model)
    cfg.save_json(os.path.join(model, "config.json"))
    tree = params_to_numpy(init_model_params(cfg, seed=0, dtype=torch.float32, device="cpu"))
    with open(os.path.join(model, "model.jax.pkl"), "wb") as f:
        pickle.dump({"params": tree, "config": cfg.to_dict()}, f)
    return model, data


def _stream_argv(model, data, out, *extra):
    return ["--model_name_or_path", model, "--data_path", data, "--output_dir", out,
            "--param_offload", "--per_device_train_batch_size", "2", "--max_steps", "2",
            "--logging_steps", "1", "--save_steps", "0", "--model_max_length", "64",
            "--learning_rate", "1e-3", *extra]


@pytest.mark.parametrize("extra", [
    ["--eval_ratio", "0.2", "--eval_steps", "1"],
    ["--moment_dtype", "int8"],
    ["--gradient_accumulation_steps", "2", "--eval_ratio", "0.2", "--eval_steps", "2"]],
    ids=["f32", "int8", "accum2"])
def test_cli_param_offload_matches_jax_cli(text_dirs, tmp_path, monkeypatch, extra):
    """Both CLIs with --param_offload on the same directories: the same rows
    (2 applied steps, evals), losses within LOSS_RTOL.  With int8 moments the
    two steps' losses see no quantized moment yet (the first update reads
    zero moments), so they too agree to LOSS_RTOL; the stochastic rounding's
    draws differ between the packages from there on."""
    model, data = text_dirs
    out_t, out_j = str(tmp_path / "t"), str(tmp_path / "j")
    assert TCLI.main(_stream_argv(model, data, out_t, "--cpu", *extra)) == 0
    one = jax.devices()[:1]
    monkeypatch.setattr(jax, "devices", lambda *a: one)
    assert JCLI.main(_stream_argv(model, data, out_j, *extra)) == 0
    got, want = _rows(out_t), _rows(out_j)
    assert [r["step"] for r in got] == [r["step"] for r in want]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in ("loss", "codec_loss", "aux_loss", "grad_norm", "eval_loss", "eval_aux_loss"):
            if k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=LOSS_RTOL, err_msg=k)
    assert sum("loss" in r for r in got) == 2
    if "--gradient_accumulation_steps" in extra:
        assert all(r["micro_batches"] == 2.0 for r in got if "loss" in r)
    for out in (out_t, out_j):
        with open(os.path.join(out, "train_done.json")) as f:
            assert json.load(f) == {"steps": 2}
        with open(os.path.join(out, "stream_ckpt", "meta.json")) as f:
            assert json.load(f)["count"] == 2


def test_cli_param_offload_resumes(text_dirs, tmp_path, capsys):
    """A second run with --max_steps 3 resumes from stream_ckpt at step 2
    and applies one more step."""
    model, data = text_dirs
    out = str(tmp_path / "out")
    argv = _stream_argv(model, data, out, "--cpu")
    assert TCLI.main(argv) == 0
    argv[argv.index("--max_steps") + 1] = "3"
    assert TCLI.main(argv) == 0
    assert "resumed stream checkpoint at step 2" in capsys.readouterr().out
    with open(os.path.join(out, "stream_ckpt", "meta.json")) as f:
        assert json.load(f)["count"] == 3
    assert [r["step"] for r in _rows(out)] == [1, 2, 3]


@pytest.mark.parametrize("extra,message", [
    (["--peft_mode", "lora"], "full-parameter"), (["--only_gate_training"], "full-parameter"),
    (["--image_root", "IMAGES"], "image samples")])
def test_cli_param_offload_refusals(dirs, text_dirs, tmp_path, extra, message):
    """PEFT, gate-only training and image samples exit with the JAX CLI's
    messages."""
    model, data = text_dirs
    if "IMAGES" in extra:
        _, model, data, _ = dirs
        extra = ["--image_root", data + "_images"]
    with pytest.raises(SystemExit, match=message):
        TCLI.main(_stream_argv(model, data, str(tmp_path / "o"), "--cpu", *extra))
