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
``--max_batch N > 1`` and a VITS model they go through the
:class:`DynamicBatcher` instead, whose worker thread decodes up to N
queued sentences of concurrent requests, of any speakers and languages, in
one dispatch. Two kinds of request take the serial path under the lock,
chosen before anything is queued: one with a ``speaker_wav``, and every
request to a model whose speakers are d-vectors (the JAX server catches the
batcher's ``ValueError`` to the same end). A request the batcher refuses
(an unknown speaker) is answered 400, as the serial path would answer it.
A model the batcher cannot take (XTTS; a mel model with a vocoder or
Griffin-Lim, GlowTTS) is served serially, with one line said at start-up. With ``--stream_batch N > 1`` ``/api/tts-stream`` goes through the
:class:`StreamBatcher`, whose worker thread batches up to N concurrent
streams.

Run: ``python -m tts_tpu_torch.server.server --model_path DIR [--device cuda]
[--speakers_file_path speakers.json] [--max_batch 4] [--batch_window_ms 10]
[--stream_batch 4] [--port 5002]``, or ``--model_path FILE --config_path
config.json`` for a VITS or GlowTTS checkpoint file, or ``--model_name
tts_models/en/vctk/vits`` for a zoo model (``--list_models`` prints the
zoo's names); ``--vocoder_path FILE --vocoder_config_path config.json``, or
``--vocoder_name``, gives a mel model its vocoder. VITS and GlowTTS serve
``/api/tts`` (their streaming route answers 501).
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
  <label>speaker <select id="speaker_id"><option value=""></option></select></label>
  <label>language <select id="language_id"><option value=""></option></select></label>
  <label>speaker wav <input id="speaker_wav" size="24" placeholder="(server path)"/></label>
</div>
<audio id="audio" controls style="margin-top: 1em; width: 100%;"></audio>
<script>
let streams = true;  // a model without a streaming path answers /api/tts
fetch('/details').then(r => r.json()).then(d => {
  streams = d.tts_config.model === 'xtts';
  for (const [id, names] of [["speaker_id", d.speakers || []], ["language_id", d.languages || []]]) {
    const el = document.getElementById(id);
    for (const n of names) { const o = document.createElement('option'); o.value = o.text = n; el.add(o); }
  }
});
function speak() {
  const p = new URLSearchParams({text: document.getElementById('text').value});
  for (const k of ["speaker_id", "language_id", "speaker_wav"]) {
    const v = document.getElementById(k).value;
    if (v) p.set(k, v);
  }
  const a = document.getElementById('audio');
  a.src = (streams ? '/api/tts-stream?' : '/api/tts?') + p.toString();
  a.play();
}
</script>
</body></html>"""


def create_handler(synthesizer, lock: threading.Lock, batcher=None, stream_batcher=None):
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
            if batcher is not None and params.get("speaker_wav") is None \
                    and not getattr(synthesizer.tts_model, "uses_d_vectors", False):
                # no lock: the batch worker owns the dispatch
                wav = batcher.tts(text, speaker_name=params.get("speaker_name"),
                                  language_name=params.get("language_name"))
            else:
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
                except NotImplementedError as e:  # e.g. speaker_wav for VITS
                    self._send(501, str(e).encode())
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
    synthesizer,
    port: int = 5002,
    max_batch: int = 1,
    batch_window_ms: float = 10.0,
    stream_batch: int = 1,
    stream_window_ms: float = 50.0,
) -> ThreadingHTTPServer:
    """HTTP server over ``synthesizer``; with ``max_batch > 1`` ``/api/tts``
    and ``/process`` go through a :class:`DynamicBatcher` where the model
    takes one, with ``stream_batch > 1`` the streaming route through a
    :class:`StreamBatcher` (both closed with the server by
    :func:`close_server`)."""
    batcher = None
    if max_batch and max_batch > 1:
        from tts_tpu_torch.server.batching import DynamicBatcher

        try:
            batcher = DynamicBatcher(synthesizer, max_batch=max_batch, window_ms=batch_window_ms)
            print(f" > Dynamic batching on: up to {max_batch} sentences per dispatch")
        except ValueError as e:
            print(f" [!] dynamic batching unavailable for this model ({e}); serving serially")
    stream_batcher = None
    if stream_batch and stream_batch > 1:
        from tts_tpu_torch.server.stream_batching import StreamBatcher

        stream_batcher = StreamBatcher(synthesizer, max_batch=stream_batch,
                                       window_ms=stream_window_ms)
        print(f" > Batched streaming on: up to {stream_batch} concurrent streams per decode")
    server = ThreadingHTTPServer(
        ("0.0.0.0", port), create_handler(synthesizer, threading.Lock(), batcher, stream_batcher)
    )
    server.batcher = batcher
    server.stream_batcher = stream_batcher
    return server


def close_server(server: ThreadingHTTPServer) -> None:
    """Stop serving, close the socket and the batchers' workers."""
    server.shutdown()
    server.server_close()
    for batcher in (server.batcher, server.stream_batcher):
        if batcher is not None:
            batcher.close()


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="tts_tpu_torch HTTP server")
    parser.add_argument("--list_models", action="store_true",
                        help="list the zoo's models and exit")
    parser.add_argument("--model_name", default=None,
                        help="zoo model name (loaded from $TTS_HOME/tts_tpu/, fetched if absent)")
    parser.add_argument("--model_path", default=None,
                        help="model directory (config.json, model_torch.pt or model.pth; XTTS "
                             "also vocab.json), or a VITS checkpoint file")
    parser.add_argument("--config_path", default=None,
                        help="config.json of a checkpoint file given as --model_path")
    parser.add_argument("--vocoder_name", default=None,
                        help="zoo vocoder name (overrides the model's default_vocoder)")
    parser.add_argument("--vocoder_path", default=None,
                        help="vocoder checkpoint for a mel model (GlowTTS)")
    parser.add_argument("--vocoder_config_path", default=None,
                        help="config.json of --vocoder_path")
    parser.add_argument("--speakers_file_path", default=None,
                        help="JSON speakers file for a multi-speaker model (replaces the "
                             "config's)")
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    parser.add_argument("--port", type=int, default=5002, help="0 picks a free port")
    parser.add_argument("--max_batch", type=int, default=1,
                        help="dynamic batching: max queued /api/tts sentences per dispatch")
    parser.add_argument("--batch_window_ms", type=float, default=10.0,
                        help="how long the first queued sentence waits for batch mates")
    parser.add_argument("--stream_batch", type=int, default=1,
                        help="max concurrent /api/tts-stream clients decoded in one batch")
    parser.add_argument("--stream_window_ms", type=float, default=50.0,
                        help="how long the first queued stream waits for batch mates")
    return parser


def server_from_args(args: argparse.Namespace) -> ThreadingHTTPServer:
    """Load the model (by zoo name or path) and build the (not yet serving)
    server."""
    from tts_tpu_torch.api import TTS, download_vocoder

    if not (args.model_name or args.model_path):
        raise ValueError("give --model_name or --model_path")
    vocoder_path, vocoder_config = args.vocoder_path, args.vocoder_config_path
    if args.vocoder_name and not vocoder_path:
        vocoder_path, vocoder_config = download_vocoder(args.vocoder_name)
    tts = TTS(model_name=args.model_name or "", model_path=args.model_path,
              config_path=args.config_path, vocoder_path=vocoder_path,
              vocoder_config_path=vocoder_config, device=args.device,
              speakers_file_path=args.speakers_file_path)
    return create_server(tts.synthesizer, args.port, max_batch=args.max_batch,
                         batch_window_ms=args.batch_window_ms, stream_batch=args.stream_batch,
                         stream_window_ms=args.stream_window_ms)


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.list_models:
        from tts_tpu_torch.utils.manage import ModelManager

        for name in ModelManager().list_models():
            print(name)
        return
    server = server_from_args(args)
    print(f" > Serving on http://0.0.0.0:{server.server_address[1]}")
    try:
        server.serve_forever()
    finally:
        close_server(server)


if __name__ == "__main__":
    main()
