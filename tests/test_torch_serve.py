"""The port's serving entry points on the CPU (tiny config, random weights,
short budgets): `apps/serve.py` (`build_server`, `measure_ttfa`, the CLI
with `--cpu --allow-random` for a single task, `--requests` through the
request batcher and `--requests --continuous` through the slot server;
`--tp-size 2` raising), `apps/inference_framework.py` on a two-task file
and its loaders, and `apps/web_demo.py`'s `StudioServer` over loopback
HTTP (generate, the NDJSON stream, a wav download, the bad-mode error).
These are behavioural tests with no numeric tolerance; the numbers they
run through are held against the JAX package in
`tests/test_torch_{batcher,continuous,speculative}.py`."""

import functools
import http.client
import json
import os
import threading

import numpy as np
import pytest
import torch

from tests.test_torch_vt2m import stable_tokenizer
from unimoe_audio_torch.apps import inference_framework as IF
from unimoe_audio_torch.apps import serve
from unimoe_audio_torch.apps.web_demo import PREDEFINED_EXAMPLES, StudioServer, format_status
from unimoe_audio_torch.codec import audio_io
from unimoe_audio_torch.config import tiny_test_config
from tests.torch_threads import one_torch_thread  # noqa: F401

SMALL = dict(max_tokens=24, min_tokens=4)


@pytest.fixture(scope="module")
def model():
    cfg = tiny_test_config()
    return serve.build_server(None, allow_random=True, config=cfg,
                              tokenizer=stable_tokenizer(cfg), device="cpu", **SMALL)


def test_build_server_and_ttfa(model):
    """One card (here the CPU); p50 and p90 of 3 timed trials, the first
    call left out."""
    assert model.device.type == "cpu" and model.MAX_TOKENS == 24
    stats = serve.measure_ttfa(model, n_trials=3)
    assert stats["trials"] == 3 and 0 < stats["p50_ttfa_s"] <= stats["p90_ttfa_s"]


def test_parallel_serving_raises():
    """An ep x tp mesh needs that many ranks: in one process without a
    process group build_server and the CLI say so (four gloo ranks serve:
    tests/test_torch_parallel.py); on a one-rank mesh the model serves the
    same greedy codes as without one."""
    import torch.distributed as dist

    from unimoe_audio_torch.api import t2m_prompt
    from unimoe_audio_torch.parallel.mesh import make_mesh, set_mesh

    with pytest.raises(ValueError, match="ranks"):
        serve.build_server(None, tp_size=2, allow_random=True, device="cpu")
    with pytest.raises(ValueError, match="ranks"):
        serve.main(["--allow-random", "--cpu", "--tp-size", "2"])
    m = serve.build_server(None, allow_random=True, config=tiny_test_config(), device="cpu",
                           dtype=torch.float32, max_tokens=12, min_tokens=4)
    assert m.mesh is None
    ids, mask = m._tokenize([t2m_prompt("a"), t2m_prompt("b c")])
    want = _greedy(m, ids, mask)
    try:
        m.use_mesh(make_mesh(1, 1, 1, device="cpu"))
        assert m.mesh.shape == {"data": 1, "expert": 1, "model": 1}
        np.testing.assert_array_equal(_greedy(m, ids, mask), want)
    finally:
        set_mesh(None)
        dist.destroy_process_group()


def _greedy(m, ids, mask):
    from unimoe_audio_torch.codec import delay as dl
    from unimoe_audio_torch.generate.loop import generate, pad_buffer

    cfg = m.config
    prefill, steps = dl.prepare_audio_prompt(
        [None], num_channels=cfg.codec_channels, bos_value=cfg.codec_bos_value,
        delay_pattern=cfg.codec_delay_pattern)
    res = generate(m.params, cfg, torch.tensor(ids), torch.tensor(mask), None,
                   pad_buffer(torch.tensor(np.asarray(prefill)), 12), steps, torch.Generator(),
                   max_tokens=12, do_sample=False, min_tokens=4, cfg_scale=3.0, temperature=1.0,
                   top_p=1.0, cfg_filter_top_k=16, eos_prob_mul_factor=1.0)
    return res.codes.numpy()


def _cli(monkeypatch, tmp_path, *args):
    monkeypatch.setattr(serve, "build_server", functools.partial(
        serve.build_server, config=tiny_test_config(), **SMALL))
    return serve.main(["--allow-random", "--cpu", "--output", str(tmp_path / "out"), *args])


def _requests_file(tmp_path):
    cfg = tiny_test_config()
    codec = np.random.default_rng(0).integers(0, cfg.codec_eos_value, size=(4, cfg.codec_channels))
    reqs = [{"task": "text_to_music", "caption": "calm piano", "seed": 3,
             "max_audio_seconds": 0.3},
            {"task": "text_to_speech", "caption": "hello there", "prompt_text": "ref words",
             "prompt_codec": codec.tolist(), "max_audio_seconds": 0.3},
            {"task": "text_to_music", "caption": "  "}]
    path = tmp_path / "reqs.json"
    path.write_text(json.dumps(reqs))
    return str(path)


@pytest.mark.parametrize("continuous", [False, True])
def test_cli_requests(tmp_path, monkeypatch, capsys, continuous):
    """--requests through the batcher: one wav per good request (T2M, and
    TTS with its prompt codes), the empty caption failing alone at the
    batcher's intake.  --requests --continuous: every request through the
    slot server (which takes any caption), one wav each, named by index."""
    argv = ["--requests", _requests_file(tmp_path)]
    if continuous:
        argv += ["--continuous", "--slots", "2", "--chunk-frames", "8"]
    assert _cli(monkeypatch, tmp_path, *argv) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    wavs = [p for p in out["outputs"] if p]
    assert all(os.path.isfile(p) and p.endswith(".wav") for p in wavs)
    if continuous:
        assert out["errors"] == []
        assert [os.path.basename(p) for p in wavs] == [
            f"generated_continuous_{i}.wav" for i in range(3)]
    else:
        assert len(wavs) == 2 and [e["index"] for e in out["errors"]] == [2]


def test_cli_single_task_and_latency(tmp_path, monkeypatch, capsys):
    assert _cli(monkeypatch, tmp_path, "--input", "a short tune") == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(out["outputs"]) == 1 and os.path.isfile(out["outputs"][0])
    assert _cli(monkeypatch, tmp_path, "--measure-latency") == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["p50_ttfa_s"] > 0
    with pytest.raises(SystemExit):
        _cli(monkeypatch, tmp_path, "--task", "text_to_speech")


def test_inference_framework_two_tasks(tmp_path, monkeypatch):
    """A T2M and a TTS task (the fixtures' reference_audio / reference_text
    spelling) from files, on the CPU; a task without its inputs fails
    alone; the results file records all three."""
    monkeypatch.setattr(IF, "UniMoEAudio", functools.partial(IF.UniMoEAudio, **SMALL))
    wav = tmp_path / "ref.wav"
    t = np.linspace(0, 0.4, 6400, dtype=np.float32)
    audio_io.write_wav(str(wav), 0.3 * np.sin(2 * np.pi * 330 * t)[None], 16000)
    cfg_file, tasks_file = tmp_path / "config.json", tmp_path / "tasks.json"
    cfg_file.write_text(json.dumps({"model_path": "unused", "allow_random": True}))
    tasks_file.write_text(json.dumps([
        {"task_type": "text_to_music", "task_id": "m1", "caption": "calm piano",
         "max_audio_seconds": 0.3, "min_audio_seconds": 0.1,
         "output_path": str(tmp_path / "music")},
        {"task_type": "text_to_speech", "task_id": "s1", "target_text": "hello there",
         "reference_audio": str(wav), "reference_text": "a reference", "max_audio_seconds": 0.3,
         "output_path": str(tmp_path / "speech")},
        {"task_type": "text_to_music", "task_id": "bad", "output_path": str(tmp_path / "b")},
    ]))
    results = tmp_path / "results.json"
    argv = ["-c", str(cfg_file), "-t", str(tasks_file), "-r", str(results), "--cpu"]
    assert IF.main(argv) == 0
    recs = json.loads(results.read_text())
    assert [r["status"] for r in recs] == ["success", "success", "failed"]
    assert all(os.path.isfile(r["output_file"]) for r in recs[:2])
    assert "Caption is required" in recs[2]["error"]
    tasks = IF.load_tasks_from_file(str(tasks_file))
    assert tasks[1].prompt_wav == str(wav) and tasks[1].prompt_text == "a reference"
    monkeypatch.chdir(tmp_path)
    assert IF.main(["--create-sample"]) == 0
    assert IF.load_config_from_file("sample_config.json").model_path.startswith("/path")


@pytest.fixture()
def studio(model, tmp_path):
    st = StudioServer(model, output_dir=str(tmp_path / "studio"))
    server = st.make_server("127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield st, server.server_address[1]
    server.shutdown()
    server.server_close()
    st.close()


def _post(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    conn.request("POST", path, json.dumps(body), {"Content-Type": "application/json"})
    resp = conn.getresponse()
    return resp.status, resp.read()


def test_studio_http(studio):
    """POST /api/generate (music through the studio's batcher) and the wav
    it names; the NDJSON stream (music decodes through
    text_to_music_stream and ends "done"); a bad mode: 500 with the error
    from /api/generate, an "error" line from the stream; the examples."""
    st, port = studio
    status, body = _post(port, "/api/generate", {"mode": "music", "text": "a calm piano piece",
                                                 "max_audio_seconds": 0.3})
    assert status == 200
    out = json.loads(body)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", out["audio"])
    resp = conn.getresponse()
    data = resp.read()
    assert resp.status == 200 and data[:4] == b"RIFF" and len(data) > 44

    status, body = _post(port, "/api/generate_stream", {"mode": "music", "text": "drums"})
    lines = [json.loads(x) for x in body.decode().splitlines() if x.strip()]
    stages = [x["status"] for x in lines]
    assert stages[0] == "preprocess" and stages[-1] == "done" and "decoding" in stages
    assert all(format_status(x) for x in lines)

    status, body = _post(port, "/api/generate", {"mode": "bogus", "text": "x"})
    assert status == 500 and "unknown mode" in json.loads(body)["error"]
    status, body = _post(port, "/api/generate_stream", {"mode": "bogus", "text": "x"})
    assert json.loads(body.decode().splitlines()[-1])["status"] == "error"

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", "/api/examples")
    assert json.loads(conn.getresponse().read()) == PREDEFINED_EXAMPLES
    conn.request("GET", "/audio/missing.wav")
    assert conn.getresponse().status == 404


def test_gradio_missing_raises(model):
    from unimoe_audio_torch.apps import web_demo

    try:
        import gradio  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError):
            web_demo.build_gradio_demo(model)
