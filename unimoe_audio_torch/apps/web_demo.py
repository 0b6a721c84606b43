#!/usr/bin/env python3
"""Web studio of the port — counterpart of `unimoe_audio_tpu/apps/web_demo.py`:
four modes (voice clone, TTS with preset voices, text-to-music,
video-to-music) behind one dispatcher, a background cleanup thread for old
outputs, and Gradio when it is installed; otherwise a small stdlib HTTP
server with the same modes and a JSON API:

  GET  /                      one-page studio UI
  GET  /api/examples          PREDEFINED_EXAMPLES
  POST /api/generate          {"mode": "music"|"voice_clone"|"tts_preset"|
                               "video_music", "text": ..., ...} → {"audio": url, "seconds": s}
  POST /api/generate_stream   the same as NDJSON status lines, the last one
                              {"status": "done", "audio": url, ...}
  GET  /audio/<name>          a generated wav

    python -m unimoe_audio_torch.apps.web_demo --model path/to/model --port 7860

Runs on the first CUDA card; `--cpu` runs on the CPU.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np

PREDEFINED_EXAMPLES = {
    "music-jazz": {
        "mode": "music",
        "description": "Generate upbeat jazz music",
        "text": "A vibrant swing jazz tune featuring a walking bassline, "
                "rhythmic ride cymbals, and an improvised saxophone solo.",
    },
    "music-lofi": {
        "mode": "music",
        "description": "Chill lo-fi hip hop beats",
        "text": "A chill lo-fi hip hop beat with mellow rhodes piano chords, "
                "a simple boom-bap drum loop, and a deep relaxed bassline.",
    },
    "voice-greeting": {
        "mode": "tts_preset",
        "description": "Preset-voice greeting",
        "text": "Welcome to the world of UniMoE Audio! Let's explore the "
                "possibilities of AI audio together.",
        "voice": "en_male",
    },
    "video-cinematic": {
        "mode": "video_music",
        "description": "Cinematic background music from video",
        "text": "Epic cinematic orchestral music with dramatic crescendos "
                "and emotional depth.",
    },
}

PRESET_VOICES = {
    "en_female": ("They're calling to us not to give up and to keep on fighting!",
                  "assets/prompt_audios/en_female.wav"),
    "en_male": ("Using script blockers is generally a good idea, but it requires the user to "
                "learn a bit.", "assets/prompt_audios/en_male.wav"),
    "zh_female": ("然而阿卡显然已经拿定主意，要援救黑老鼠。", "assets/prompt_audios/zh_female.wav"),
    "zh_male": ("小偷却一点也不气馁，继续在抽屉里翻找。", "assets/prompt_audios/zh_male.wav"),
}

_PAGE = """<!doctype html>
<html><head><title>UniMoE-Audio Studio</title>
<style>
 body{font-family:system-ui;margin:2rem auto;max-width:780px;color:#222}
 fieldset{margin:1rem 0;border:1px solid #ccc;border-radius:8px}
 textarea,input,select{width:100%;margin:.3rem 0;padding:.4rem}
 button{padding:.6rem 1.4rem;margin-top:.5rem;cursor:pointer}
 #status{margin-top:1rem;white-space:pre-wrap;font-family:monospace}
</style></head><body>
<h1>UniMoE-Audio <small>studio</small></h1>
<fieldset><legend>Mode</legend>
<select id=mode onchange="sw()">
 <option value=music>Text → Music</option>
 <option value=voice_clone>Voice clone (your reference)</option>
 <option value=tts_preset>TTS (preset voices)</option>
 <option value=video_music>Video + Text → Music</option>
</select></fieldset>
<fieldset><legend>Inputs</legend>
<textarea id=text rows=3 placeholder="Describe the music / enter target speech"></textarea>
<div id=clone style="display:none">
 <input id=ref_text placeholder="Reference transcript">
 <input id=ref_path placeholder="Path to reference wav (server-side)">
</div>
<div id=preset style="display:none">
 <select id=voice>%OPTS%</select>
</div>
<div id=video style="display:none">
 <input id=video_path placeholder="Path to video file (server-side)">
</div>
</fieldset>
<button onclick="go()">Generate</button>
<fieldset><legend>Examples</legend>%EXAMPLES%</fieldset>
<div id=status></div>
<audio id=player controls style="width:100%;margin-top:1rem;display:none"></audio>
<script>
function sw(){const m=document.getElementById('mode').value;
 clone.style.display=m=='voice_clone'?'':'none';
 preset.style.display=m=='tts_preset'?'':'none';
 video.style.display=m=='video_music'?'':'none';}
function pick(m,t,v){document.getElementById('mode').value=m;
 text.value=t; if(v) voice.value=v; sw();}
function show(j){
 if(j.status=='error'){status.textContent='Error: '+j.error;return;}
 if(j.status=='preprocess')status.textContent='Preprocessing…';
 else if(j.status=='decoding')status.textContent=
   'Decoding: '+j.frames+(j.of?'/'+j.of:'')+' frames ('+j.audio_seconds+' s audio)…';
 else if(j.status=='generating')status.textContent='Generating…';
 else if(j.status=='writing')status.textContent='Writing wav…';
 else if(j.status=='done'){
  status.textContent='Done in '+j.seconds.toFixed(1)+' s';
  player.src=j.audio;player.style.display='';player.play();}}
async function go(){
 const m=document.getElementById('mode').value;
 status.textContent='Starting…';player.style.display='none';
 const body={mode:m,text:text.value,ref_text:ref_text.value,
   ref_path:ref_path.value,voice:voice.value,video_path:video_path.value};
 const r=await fetch('/api/generate_stream',{method:'POST',
   headers:{'Content-Type':'application/json'},body:JSON.stringify(body)});
 const reader=r.body.getReader();const dec=new TextDecoder();let rest='';
 for(;;){const {done,value}=await reader.read();if(done)break;
  rest+=dec.decode(value,{stream:true});
  const lines=rest.split('\\n');rest=lines.pop();
  for(const ln of lines)if(ln.trim())show(JSON.parse(ln));}}
</script></body></html>"""


class StudioServer:
    """The studio's dispatcher over one model.  Music requests go through
    a RequestBatcher (concurrent requests share one generation batch) unless
    batch_requests is False.  close() stops the batcher and the cleanup
    thread."""

    def __init__(self, model, *, output_dir: Optional[str] = None, cleanup_age_s: int = 3600,
                 batch_requests: bool = True):
        self.model = model
        self.output_dir = output_dir or tempfile.mkdtemp(prefix="unimoe_studio_")
        os.makedirs(self.output_dir, exist_ok=True)
        self._closed = threading.Event()
        self._start_cleanup_thread(cleanup_age_s)
        self.batcher = None
        if batch_requests:
            from .batcher import RequestBatcher

            self.batcher = RequestBatcher(model, output_dir=self.output_dir)

    def _start_cleanup_thread(self, max_age: int) -> None:
        """Every 5 minutes, remove outputs older than max_age seconds."""
        def loop():
            while not self._closed.is_set():
                now = time.time()
                try:
                    for f in os.listdir(self.output_dir):
                        p = os.path.join(self.output_dir, f)
                        if os.path.isfile(p) and now - os.path.getmtime(p) > max_age:
                            os.remove(p)
                except OSError:
                    pass
                self._closed.wait(300)

        threading.Thread(target=loop, daemon=True).start()

    def close(self) -> None:
        self._closed.set()
        if self.batcher is not None:
            self.batcher.close()

    def generate_stream(self, req: Dict):
        """Status dicts while the request runs: {"status": "preprocess"},
        decode progress ("decoding", frame counts; music streams through
        `text_to_music_stream`), "writing", and last {"status": "done",
        "audio": url, "seconds": s} — or {"status": "error", "error": msg},
        since a failure stays inside the status protocol."""
        try:
            yield from self._generate_stream(req)
        except Exception as e:  # noqa: BLE001 — surfaced through the protocol
            yield {"status": "error", "error": str(e)}

    def _generate_stream(self, req: Dict):
        from ..codec import audio_io

        mode = req.get("mode", "music")
        text = (req.get("text") or "").strip()
        t0 = time.time()
        yield {"status": "preprocess", "mode": mode}
        if mode == "music" and text:
            frames, waves = 0, []
            max_frames = getattr(self.model, "MAX_TOKENS", 0) or 0
            for chunk in self.model.text_to_music_stream(text):
                n = int(chunk["frames"].shape[1])
                frames += n
                if chunk.get("audio") is not None and n:
                    waves.append(np.asarray(chunk["audio"])[0])
                yield {"status": "decoding", "frames": frames, "of": max_frames,
                       "audio_seconds": round(frames / 50.0, 2)}
            yield {"status": "writing", "frames": frames}
            if not waves:
                raise RuntimeError("generation produced no audio")
            out = os.path.join(self.output_dir, f"web_{int(t0 * 1e3)}_stream.wav")
            audio_io.write_wav(out, np.concatenate(waves)[None], self.model.dac.config.sample_rate)
            yield {"status": "done", "audio": "/audio/" + os.path.basename(out),
                   "frames": frames, "seconds": time.time() - t0}
            return
        yield {"status": "generating", "mode": mode}
        yield dict(self.generate(req), status="done")

    def generate(self, req: Dict) -> Dict:
        """One request, blocking: {"audio": "/audio/<name>", "seconds": s}.
        A music request may carry max_audio_seconds."""
        mode = req.get("mode", "music")
        text = (req.get("text") or "").strip()
        t0 = time.time()
        save = f"web_{int(t0 * 1e3)}"
        length = {k: req[k] for k in ("max_audio_seconds",) if req.get(k) is not None}
        if mode == "music":
            if self.batcher is not None:
                paths = [self.batcher.submit("text_to_music",
                                             {"caption": text, **length}).result()]
            else:
                paths = self.model.text_to_music(text, save_name=save,
                                                 output_dir=self.output_dir, **length)
        elif mode == "voice_clone":
            paths = self.model.text_to_speech(text, prompt_text=req.get("ref_text", ""),
                                              prompt_wav=req.get("ref_path"), save_name=save,
                                              output_dir=self.output_dir)
        elif mode == "tts_preset":
            ref_text, ref_path = PRESET_VOICES.get(req.get("voice", "en_female"),
                                                   PRESET_VOICES["en_female"])
            paths = self.model.text_to_speech(text, prompt_text=ref_text, prompt_wav=ref_path,
                                              save_name=save, output_dir=self.output_dir)
        elif mode == "video_music":
            paths = self.model.video_text_to_music(video=req.get("video_path"), caption=text,
                                                   save_name=save, output_dir=self.output_dir)
        else:
            raise ValueError(f"unknown mode: {mode}")
        if not paths:
            raise RuntimeError("generation produced no output")
        return {"audio": "/audio/" + os.path.basename(paths[0]), "seconds": time.time() - t0}

    def make_server(self, host: str = "0.0.0.0", port: int = 7860) -> ThreadingHTTPServer:
        """The studio's HTTP server, bound but not serving (port 0 takes a
        free port: `server.server_address`)."""
        studio = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def _send(self, code, body, ctype="application/json"):
                data = body if isinstance(body, bytes) else body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                path = urllib.parse.urlparse(self.path).path
                if path == "/":
                    opts = "".join(f"<option value={k}>{k}</option>" for k in PRESET_VOICES)
                    ex = "".join(
                        "<button onclick=\"pick('{m}',{t!r},{v!r})\">{d}</button> ".format(
                            m=e["mode"], t=e["text"], v=e.get("voice", ""), d=e["description"])
                        for e in PREDEFINED_EXAMPLES.values())
                    self._send(200, _PAGE.replace("%OPTS%", opts).replace("%EXAMPLES%", ex),
                               "text/html")
                elif path == "/api/examples":
                    self._send(200, json.dumps(PREDEFINED_EXAMPLES))
                elif path.startswith("/audio/"):
                    fp = os.path.join(studio.output_dir, os.path.basename(path[len("/audio/"):]))
                    if os.path.isfile(fp):
                        with open(fp, "rb") as f:
                            self._send(200, f.read(), "audio/wav")
                    else:
                        self._send(404, json.dumps({"error": "not found"}))
                else:
                    self._send(404, json.dumps({"error": "not found"}))

            def do_POST(self):
                path = urllib.parse.urlparse(self.path).path
                n = int(self.headers.get("Content-Length", 0))
                if path == "/api/generate":
                    try:
                        out = studio.generate(json.loads(self.rfile.read(n) or b"{}"))
                        self._send(200, json.dumps(out))
                    except Exception as e:  # noqa: BLE001 — surfaced to the client
                        self._send(500, json.dumps({"error": str(e)}))
                elif path == "/api/generate_stream":
                    # Chunked NDJSON: one status line per stage or decode chunk.
                    self.send_response(200)
                    self.send_header("Content-Type", "application/x-ndjson")
                    self.send_header("Cache-Control", "no-cache")
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()

                    def chunk(obj):
                        data = (json.dumps(obj) + "\n").encode()
                        self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
                        self.wfile.flush()

                    try:
                        for status in studio.generate_stream(
                                json.loads(self.rfile.read(n) or b"{}")):
                            chunk(status)
                    except (ValueError, OSError) as e:     # a bad body or a closed client
                        try:
                            chunk({"status": "error", "error": str(e)})
                        except OSError:
                            pass
                    try:
                        self.wfile.write(b"0\r\n\r\n")
                    except OSError:
                        pass
                else:
                    self._send(404, json.dumps({"error": "not found"}))

        return ThreadingHTTPServer((host, port), Handler)

    def serve(self, host: str = "0.0.0.0", port: int = 7860) -> None:
        server = self.make_server(host, port)
        print(f"UniMoE-Audio studio at http://{host}:{port}  (outputs: {self.output_dir})")
        server.serve_forever()


def format_status(j: Dict) -> str:
    """One status line per stage dict (both UIs)."""
    s = j.get("status")
    if s == "preprocess":
        return "Preprocessing…"
    if s == "decoding":
        of = f"/{j['of']}" if j.get("of") else ""
        return f"Decoding: {j['frames']}{of} frames ({j.get('audio_seconds', 0)} s audio)…"
    if s == "generating":
        return "Generating…"
    if s == "writing":
        return "Writing wav…"
    if s == "done":
        return f"Done in {j['seconds']:.1f} s"
    if s == "error":
        return f"Error: {j.get('error')}"
    return str(j)


def build_gradio_demo(model):
    """The Gradio Blocks UI; raises ImportError without gradio.  The
    dispatcher is a generator, so each status streams to the UI through
    demo.queue()."""
    import gradio as gr

    studio = StudioServer(model)

    def dispatch(mode, text, ref_text, ref_audio, voice, video):
        req = {"mode": mode, "text": text, "ref_text": ref_text, "ref_path": ref_audio,
               "voice": voice, "video_path": video}
        for j in studio.generate_stream(req):
            wav = (os.path.join(studio.output_dir, os.path.basename(j["audio"]))
                   if j.get("status") == "done" else None)
            yield format_status(j), wav

    with gr.Blocks(title="UniMoE-Audio") as demo:
        gr.Markdown("# UniMoE-Audio — studio")
        mode = gr.Radio(["music", "voice_clone", "tts_preset", "video_music"], value="music",
                        label="Mode")
        text = gr.Textbox(label="Text / caption", lines=3)
        ref_text = gr.Textbox(label="Reference transcript (voice clone)")
        ref_audio = gr.Audio(label="Reference audio (voice clone)", type="filepath")
        voice = gr.Dropdown(list(PRESET_VOICES), value="en_female", label="Preset voice")
        video = gr.Video(label="Video (video → music)")
        status_out = gr.Textbox(label="Status", interactive=False)
        audio_out = gr.Audio(label="Generated audio")
        gr.Button("Generate").click(dispatch, [mode, text, ref_text, ref_audio, voice, video],
                                    [status_out, audio_out])
    return demo


def main(argv=None) -> None:
    import argparse

    from unimoe_audio_torch.api import UniMoEAudio

    parser = argparse.ArgumentParser(description="UniMoE-Audio studio (PyTorch port)")
    parser.add_argument("--model", default=None)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=7860)
    parser.add_argument("--allow-random", action="store_true")
    parser.add_argument("--serving-mode", action="store_true",
                        help="int8 weights, padded expert FFNs, packed dispatch")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = parser.parse_args(argv)

    model = UniMoEAudio(args.model, allow_random=args.allow_random,
                        serving_mode=args.serving_mode, device="cpu" if args.cpu else None)
    try:
        demo = build_gradio_demo(model)
    except ImportError:
        StudioServer(model).serve(host=args.host, port=args.port)
    else:
        demo.queue().launch(server_port=args.port)


if __name__ == "__main__":
    main()
