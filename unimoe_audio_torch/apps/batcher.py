"""Concurrent request batching for serving — counterpart of
`unimoe_audio_tpu/apps/batcher.py`.

A card decodes fastest when requests share one generation batch, so this
module coalesces concurrent requests:

  * callers submit (task, payload) and wait on a Future;
  * a worker drains the queue every `window_s` and runs EVERY task type in
    ONE heterogeneous batch through `UniMoEAudio.generate_mixed`: each
    request's sampling knobs, length budget and seed ride the batch as
    per-sample vectors;
  * the results fan back out to the callers.

The JAX worker pads each batch to a size bucket (1, 2, 4, 8, 16, 32, 48
requests) so that its compiled programs are reused.  The port runs eagerly and has nothing to
reuse, so it decodes the batch as it is: padding rows change no request's
output, they only cost decode work.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List

# Errors that belong to one request (a bad field, a malformed prompt): worth
# retrying the batch's requests one by one.  Anything else (a CUDA build or
# launch failure, out of memory) is systemic and fails the whole batch.
# What a request brings from outside (its prompt wav, its video file, the
# tower it needs) is checked at intake (`UniMoEAudio.check_mixed_request`),
# where a fault there fails only its own Future.
REQUEST_ERRORS = (ValueError, KeyError, TypeError, AssertionError)


class RequestBatcher:
    def __init__(self, model, *, window_s: float = 0.1, output_dir: str = "./served",
                 max_batch: int = 48):
        self.model = model
        self.window_s = window_s
        self.output_dir = output_dir
        self.max_batch = max_batch
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self.error = None       # the systemic error that stopped the worker
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, task_type: str, payload: Dict) -> Future:
        if self.error is not None:
            raise RuntimeError("the batcher stopped on a systemic error") from self.error
        fut: Future = Future()
        self._q.put((task_type, payload, fut))
        return fut

    def close(self):
        self._stop.set()
        self._worker.join(timeout=5)

    def _drain(self) -> List:
        items = []
        try:
            items.append(self._q.get(timeout=self.window_s))
        except queue.Empty:
            return items
        deadline = time.time() + self.window_s
        while len(items) < self.max_batch and time.time() < deadline:
            try:
                items.append(self._q.get_nowait())
            except queue.Empty:
                time.sleep(0.005)
        return items

    # Payload spellings of the checkpoint variant's API.
    _TTS_ALIASES = {"transcription": "caption", "prompt_transcription": "prompt_text"}

    def _to_request(self, task: str, payload: Dict) -> Dict:
        """A generate_mixed request dict, validated here so that a malformed
        request fails its own Future instead of the coalesced batch."""
        req = {"task": task}
        for k, v in payload.items():
            if k in ("save_name", "output_dir"):
                continue
            req[self._TTS_ALIASES.get(k, k)] = v
        self.model.check_mixed_request(req)
        if not str(req.get("caption", "")).strip():
            raise ValueError("empty caption")
        if task == "text_to_speech":
            if not str(req.get("prompt_text", "")).strip():
                raise ValueError("text_to_speech requires prompt_text/prompt_transcription")
            # The reference's TTS clamps to 2-10 s.
            req["max_audio_seconds"] = min(float(req.get("max_audio_seconds", 10)), 10)
            req["min_audio_seconds"] = max(float(req.get("min_audio_seconds", 2)), 2)
        return req

    def _run(self):
        while not self._stop.is_set():
            items = self._drain()
            if not items:
                continue
            batch = []   # (request dict, future)
            for t, p, fut in items:
                try:
                    batch.append((self._to_request(t, p), fut))
                except Exception as e:  # noqa: BLE001 — fails its own Future
                    fut.set_exception(e)
            if not batch:
                continue
            # A request's "seed" gives it its own counter-based chain, so its
            # draws do not depend on the requests beside it (dense dispatch;
            # capacity-packed dispatch can still couple rows).
            try:
                paths = self.model.generate_mixed(
                    [r for r, _ in batch], output_dir=self.output_dir,
                    save_name=f"batch_{int(time.time() * 1e3)}")
                assert len(paths) == len(batch), "batch result misaligned"
                for (_, fut), path in zip(batch, paths):
                    if not fut.done():
                        fut.set_result(path)
            except Exception as e:  # noqa: BLE001 — triaged below
                self._run_individually(batch, e)

    def _run_individually(self, batch, batch_exc):
        """After a failed batch, retry each request alone, so that one
        poisoned request fails only its own Future.  Only request errors
        (REQUEST_ERRORS) are retried; a systemic error (a CUDA build or
        launch failure, out of memory) is not retried: it fails every
        request of the batch and every queued one, and stops the worker
        (`submit` then raises it)."""
        if not isinstance(batch_exc, REQUEST_ERRORS):
            self._fail_all(batch, batch_exc)
            return
        print(f"[batcher] coalesced batch failed ({batch_exc!r}); retrying {len(batch)} "
              "request(s) individually")
        for i, (req, fut) in enumerate(batch):
            if fut.done():
                continue
            try:
                paths = self.model.generate_mixed(
                    [req], output_dir=self.output_dir,
                    save_name=f"retry_{int(time.time() * 1e3)}_{i}")
                fut.set_result(paths[0])
            except Exception as e:  # noqa: BLE001 — triaged as above
                if not isinstance(e, REQUEST_ERRORS):
                    self._fail_all(batch, e)
                    return
                fut.set_exception(e)

    def _fail_all(self, batch, exc) -> None:
        print(f"[batcher] stopping on a systemic error ({exc!r})")
        self.error = exc
        self._stop.set()
        pending = [fut for _, fut in batch]
        while True:
            try:
                pending.append(self._q.get_nowait()[2])
            except queue.Empty:
                break
        for fut in pending:
            if not fut.done():
                fut.set_exception(exc)
