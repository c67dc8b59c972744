"""TTS HTTP server of the port (counterpart of ``tts_tpu/server/server.py``),
on the standard library's ``http.server``.

Routes:
  GET /                 minimal HTML page
  GET /api/tts          ?text=…&speaker_id=…&language_id=…&speaker_wav=… → wav
  GET /api/tts-stream   same parameters → progressive WAV, written per
                        decoded chunk
  GET /details          the model's config as JSON, with its speakers and
                        languages (empty for a model without managers)
  MaryTTS compatibility: GET /locales, GET /voices, GET and POST /process
                        (``INPUT_TEXT`` → wav)

Status codes, content types and bodies are the JAX server's; any other
route answers 404. ``/api/tts`` and ``/process`` run under one lock. With
``--stream_batch N > 1`` ``/api/tts-stream`` goes through the
:class:`StreamBatcher`, whose worker thread batches up to N concurrent
streams.

Run: ``python -m tts_tpu_torch.server.server --model_path DIR [--device cuda]
[--stream_batch 4] [--port 5002]``, or ``--model_path FILE --config_path
config.json`` for a VITS checkpoint file. A VITS model serves ``/api/tts``
(its streaming route answers 501).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import struct
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import scipy.io.wavfile


_INDEX_HTML = """<!DOCTYPE html>
<html><head><title>tts_tpu_torch server</title></head>
<body style="font-family: sans-serif; max-width: 48em; margin: 2em auto;">
<h1>tts_tpu_torch</h1>
<div>
  <input id="text" size="60" placeholder="Type a sentence..."/>
  <button onclick="speak()">Speak</button>
</div>
<div style="margin-top: 0.6em;">
  <label>language <input id="language_id" size="6" value="en"/></label>
  <label>speaker wav <input id="speaker_wav" size="24" placeholder="(server path)"/></label>
</div>
<audio id="audio" controls style="margin-top: 1em; width: 100%;"></audio>
<script>
function speak() {
  const p = new URLSearchParams({text: document.getElementById('text').value});
  for (const k of ["language_id", "speaker_wav"]) {
    const v = document.getElementById(k).value;
    if (v) p.set(k, v);
  }
  const a = document.getElementById('audio');
  a.src = '/api/tts-stream?' + p.toString();
  a.play();
}
</script>
</body></html>"""


def create_handler(synthesizer, lock: threading.Lock, stream_batcher=None):
    class TTSHandler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            print(" > %s" % (fmt % args))

        def _send(self, code: int, content: bytes, ctype: str = "text/html"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(content)))
            self.end_headers()
            self.wfile.write(content)

        def _params(self, qs):
            return dict(
                speaker_name=(qs.get("speaker_id") or [None])[0],
                language_name=(qs.get("language_id") or [None])[0],
                speaker_wav=(qs.get("speaker_wav") or [None])[0],
            )

        def _synthesize(self, text: str, **params) -> bytes:
            with lock:
                wav = synthesizer.tts(text, **params)
            arr = np.asarray(wav, np.float32)
            arr = (arr * (32767 / max(0.01, float(np.abs(arr).max())))).astype(np.int16)
            buf = io.BytesIO()
            scipy.io.wavfile.write(buf, synthesizer.output_sample_rate, arr)
            return buf.getvalue()

        def _stream_tts(self, qs):
            """Chunked synthesis → progressive 16-bit PCM WAV with an
            open-ended RIFF header, flushed per decoded chunk."""
            text = (qs.get("text") or [""])[0]
            if not text.strip():
                self._send(400, b"missing text")
                return
            sr = synthesizer.output_sample_rate
            empty = object()
            # pull the first chunk BEFORE the headers so a bad request still
            # gets an error status; later chunks are pulled under the lock,
            # never across socket writes
            if stream_batcher is not None:
                gen = stream_batcher.stream(text, **self._params(qs))
                chunk_lock = contextlib.nullcontext()  # the batch worker owns the device
            else:
                gen = synthesizer.tts_stream(text, **self._params(qs))
                chunk_lock = lock
            try:
                with chunk_lock:
                    first = next(gen, empty)
            except ValueError as e:
                self._send(400, str(e).encode())
                return
            except NotImplementedError as e:  # a model without a streaming path
                self._send(501, str(e).encode())
                return

            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.end_headers()
            try:
                self.wfile.write(
                    b"RIFF" + struct.pack("<I", 0xFFFFFFFF) + b"WAVEfmt "
                    + struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16)
                    + b"data" + struct.pack("<I", 0xFFFFFFFF)
                )
                chunk = first
                while chunk is not empty:
                    pcm = np.clip(np.asarray(chunk, np.float32), -1.0, 1.0)
                    self.wfile.write((pcm * 32767).astype("<i2").tobytes())
                    self.wfile.flush()
                    with chunk_lock:
                        chunk = next(gen, empty)
            except (BrokenPipeError, ConnectionResetError):
                pass  # client hung up mid-stream
            except Exception as e:  # headers are out: stop the body, report here
                print(f" [!] tts-stream aborted mid-stream: {e!r}")

        def do_GET(self):
            parsed = urllib.parse.urlparse(self.path)
            qs = urllib.parse.parse_qs(parsed.query)
            route = parsed.path
            if route == "/":
                self._send(200, _INDEX_HTML.encode())
            elif route == "/api/tts-stream":
                self._stream_tts(qs)
            elif route == "/api/tts":
                text = (qs.get("text") or [""])[0]
                if not text.strip():
                    self._send(400, b"missing text")
                    return
                try:
                    wav = self._synthesize(text, **self._params(qs))
                except ValueError as e:
                    self._send(400, str(e).encode())
                    return
                self._send(200, wav, "audio/wav")
            elif route == "/details":
                self._details()
            elif route == "/locales":  # MaryTTS compatibility
                self._send(200, b"en_US\n", "text/plain")
            elif route == "/voices":  # MaryTTS compatibility
                self._send(200, b"default en_US u\n", "text/plain")
            elif route == "/process":  # MaryTTS compatibility
                self._process(qs)
            else:
                self._send(404, b"not found")

        def do_POST(self):
            parsed = urllib.parse.urlparse(self.path)
            if parsed.path == "/process":  # MaryTTS compatibility: a form body
                length = int(self.headers.get("Content-Length", "0"))
                self._process(urllib.parse.parse_qs(self.rfile.read(length).decode()))
            else:
                self._send(404, b"not found")

        def _process(self, qs):
            try:
                wav = self._synthesize((qs.get("INPUT_TEXT") or [""])[0])
            except ValueError as e:
                self._send(400, str(e).encode())
                return
            self._send(200, wav, "audio/wav")

        def _details(self):
            sm = getattr(synthesizer.tts_model, "speaker_manager", None)
            lm = getattr(synthesizer.tts_model, "language_manager", None)
            details = {
                "tts_config": synthesizer.tts_config.to_dict(),
                "speakers": list(getattr(sm, "name_to_id", {}) or {}) if sm else [],
                "languages": list(getattr(lm, "name_to_id", {}) or {}) if lm else [],
            }
            self._send(200, json.dumps(details, default=str).encode(), "application/json")

    return TTSHandler


def create_server(
    synthesizer, port: int = 5002, stream_batch: int = 1, stream_window_ms: float = 50.0
) -> ThreadingHTTPServer:
    """HTTP server over ``synthesizer``; with ``stream_batch > 1`` the
    streaming route goes through a :class:`StreamBatcher` (closed with the
    server by :func:`close_server`)."""
    stream_batcher = None
    if stream_batch and stream_batch > 1:
        from tts_tpu_torch.server.stream_batching import StreamBatcher

        stream_batcher = StreamBatcher(synthesizer, max_batch=stream_batch,
                                       window_ms=stream_window_ms)
        print(f" > Batched streaming on: up to {stream_batch} concurrent streams per decode")
    server = ThreadingHTTPServer(
        ("0.0.0.0", port), create_handler(synthesizer, threading.Lock(), stream_batcher)
    )
    server.stream_batcher = stream_batcher
    return server


def close_server(server: ThreadingHTTPServer) -> None:
    """Stop serving, close the socket and the stream batcher's worker."""
    server.shutdown()
    server.server_close()
    if server.stream_batcher is not None:
        server.stream_batcher.close()


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="tts_tpu_torch HTTP server")
    parser.add_argument("--model_path", required=True,
                        help="model directory (config.json, model_torch.pt or model.pth; XTTS "
                             "also vocab.json), or a VITS checkpoint file")
    parser.add_argument("--config_path", default=None,
                        help="config.json of a checkpoint file given as --model_path")
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    parser.add_argument("--port", type=int, default=5002, help="0 picks a free port")
    parser.add_argument("--stream_batch", type=int, default=1,
                        help="max concurrent /api/tts-stream clients decoded in one batch")
    parser.add_argument("--stream_window_ms", type=float, default=50.0,
                        help="how long the first queued stream waits for batch mates")
    return parser


def server_from_args(args: argparse.Namespace) -> ThreadingHTTPServer:
    """Load the model directory and build the (not yet serving) server."""
    from tts_tpu_torch.api import TTS

    tts = TTS(model_path=args.model_path, config_path=args.config_path, device=args.device)
    return create_server(tts.synthesizer, args.port, stream_batch=args.stream_batch,
                         stream_window_ms=args.stream_window_ms)


def main(argv=None):
    server = server_from_args(build_parser().parse_args(argv))
    print(f" > Serving on http://0.0.0.0:{server.server_address[1]}")
    try:
        server.serve_forever()
    finally:
        close_server(server)


if __name__ == "__main__":
    main()
