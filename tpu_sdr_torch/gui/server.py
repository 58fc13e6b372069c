"""Stdlib web server for the live analyzer GUI (no Flask dependency).

Serves the self-contained front-end, a Server-Sent-Events stream for
``frame_data`` / ``receiver_status`` / ``filter_preview`` events, and JSON
POST endpoints mirroring the reference's SocketIO event set
(``fft_analyzer_gui.py:989-1234``):

  POST /api/start_receiver      POST /api/stop_receiver
  POST /api/set_mode            {"mode": "ethernet"|"uart"}
  POST /api/fpga_reset
  POST /api/set_filter_type     {"mode": "fixed"|"custom"|"bypass"}
  POST /api/set_display_mode    {"mode": "magnitude"|"real"|"imag"|"power"}
  POST /api/send_command        {"hex": "b1 55"}  (raw command console)
  POST /api/apply_frequency_range {"lo_khz": .., "hi_khz": ..}
  POST /api/update_filter_config  {designer fields}
  POST /api/update_config       {display_fps, display_points, waterfall_enabled}
  POST /api/set_zoom            {"enabled": bool, "channel": 0..127}
  POST /api/set_trigger         {"enabled", "mode", "f_lo_khz", "f_hi_khz",
                                 "threshold_db", "rearm"}
  POST /api/start_record        {"max_seconds": 60} -> captures/<ts>.npy
  POST /api/stop_record         finalize; returns capture metadata
  POST /api/set_audio           {"enabled", "center_khz", "mode", "max_seconds"}
  POST /api/save_audio          write buffered audio -> captures/audio_<ts>.wav
  POST /api/rds                 {"center_khz", "path"?, "deviation_khz"?}
  POST /api/demod_burst         {"scheme", "bits", "sps", "center_khz",
                                 "path"|live-ring} -> bits hex + sync
                                 estimates + constellation points
  POST /api/scan                {"start_khz", "stop_khz", "bw_khz",
                                 "threshold_db"} -> occupancy table + hits
  POST /api/reset_plot
  POST /api/generate_filter_preview
  POST /api/apply_filter_to_fpga
  GET  /api/state               GET /api/roofline
  GET  /api/q15_frame           last faithful-mode wire frame (base64)
  GET  /events (SSE)

Run: ``python -m tpu_sdr_torch.gui.server [port] [iq] [cpu]`` — starts a
synthetic-source demo analyzer on http://localhost:5000, on the GPU (``cpu``:
on the CPU, with the kernels' plain versions).
"""

from __future__ import annotations

import json
import os
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from tpu_sdr_torch.gui.backend import GuiBackend

_INDEX = os.path.join(os.path.dirname(__file__), "templates", "index.html")


def _make_handler(backend: GuiBackend):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet
            pass

        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                with open(_INDEX, "rb") as f:
                    body = f.read()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/api/state":
                self._json(backend.get_state())
            elif self.path == "/api/roofline":
                self._json(backend.get_roofline())
            elif self.path == "/api/q15_frame":
                try:
                    self._json(backend.get_q15_frame())
                except ValueError as e:
                    self._json({"error": str(e)}, code=400)
            elif self.path == "/events":
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Connection", "close")
                self.end_headers()
                q = backend.subscribe()
                try:
                    while True:
                        try:
                            event, payload = q.get(timeout=15.0)
                        except queue.Empty:
                            self.wfile.write(b": keepalive\n\n")
                            self.wfile.flush()
                            continue
                        msg = f"event: {event}\ndata: {payload}\n\n".encode()
                        self.wfile.write(msg)
                        self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError, OSError):
                    pass
                finally:
                    backend.unsubscribe(q)
            else:
                self._json({"error": "not found"}, 404)

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0) or 0)
            raw = self.rfile.read(length) if length else b"{}"
            try:
                args = json.loads(raw or b"{}")
            except json.JSONDecodeError:
                self._json({"ok": False, "error": "invalid JSON body"}, 400)
                return
            route = self.path
            try:
                if route == "/api/start_receiver":
                    backend.start_receiver()
                    self._json({"ok": True})
                elif route == "/api/stop_receiver":
                    backend.stop_receiver()
                    self._json({"ok": True})
                elif route == "/api/set_mode":
                    backend.set_mode(str(args.get("mode", "ethernet")))
                    self._json({"ok": True})
                elif route == "/api/fpga_reset":
                    backend.fpga_reset()
                    self._json({"ok": True})
                elif route == "/api/send_command":
                    self._json(
                        backend.send_command_bytes(str(args.get("hex", "")))
                    )
                elif route == "/api/set_display_mode":
                    backend.set_display_mode(str(args.get("mode", "magnitude")))
                    self._json({"ok": True})
                elif route == "/api/set_filter_type":
                    backend.set_filter_type(str(args.get("mode", "bypass")))
                    self._json({"ok": True})
                elif route == "/api/apply_frequency_range":
                    backend.apply_frequency_range(
                        float(args.get("lo_khz", 0)),
                        float(args.get("hi_khz", 500)),
                    )
                    self._json({"ok": True})
                elif route == "/api/update_filter_config":
                    backend.update_filter_config(dict(args))
                    self._json({"ok": True})
                elif route == "/api/update_config":
                    backend.update_config(dict(args))
                    self._json({"ok": True})
                elif route == "/api/reset_plot":
                    backend.reset_plot()
                    self._json({"ok": True})
                elif route == "/api/set_zoom":
                    self._json(backend.set_zoom(dict(args)))
                elif route == "/api/set_trigger":
                    self._json(backend.set_trigger(dict(args)))
                elif route == "/api/start_record":
                    self._json(
                        backend.start_record(
                            float(args.get("max_seconds", 60.0))
                        )
                    )
                elif route == "/api/stop_record":
                    self._json(backend.stop_record())
                elif route == "/api/set_audio":
                    self._json(backend.set_audio(dict(args)))
                elif route == "/api/save_audio":
                    self._json(backend.save_audio())
                elif route == "/api/scan":
                    self._json(backend.scan_band(dict(args)))
                elif route == "/api/demod_burst":
                    self._json(backend.demod_burst(dict(args)))
                elif route == "/api/rds":
                    self._json(backend.rds_decode(dict(args)))
                elif route == "/api/generate_filter_preview":
                    self._json(backend.generate_filter_preview())
                elif route == "/api/generate_filter_preview_png":
                    self._json(backend.generate_filter_preview_png())
                elif route == "/api/apply_filter_to_fpga":
                    self._json(backend.apply_filter())
                else:
                    self._json({"error": "not found"}, 404)
            except (KeyError, ValueError, TypeError) as e:
                self._json({"ok": False, "error": str(e)}, 400)

    return Handler


def serve(
    backend: GuiBackend | None = None,
    port: int = 5000,
    bind: str = "0.0.0.0",
    start_receiver: bool = True,
    block: bool = True,
    device=None,
):
    """Start the GUI server; returns (server, backend) when block=False.
    Without a ``backend``, a default one is built on ``device`` (None:
    CUDA, raising without a GPU)."""
    backend = backend or GuiBackend(device=device)
    server = ThreadingHTTPServer((bind, port), _make_handler(backend))
    if start_receiver:
        backend.start_receiver()
    if block:
        try:
            server.serve_forever()
        finally:
            backend.stop_receiver()
    else:
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
    return server, backend


if __name__ == "__main__":
    import sys

    args = sys.argv[1:]
    iq = "iq" in args
    device = "cpu" if "cpu" in args else None
    args = [a for a in args if a not in ("iq", "cpu")]
    port = int(args[0]) if args else 5000
    # Demo: pace the synthetic source to its nominal 1 MSPS (the unpaced
    # path exists for throughput benchmarking; a demo shouldn't spin a core).
    backend = GuiBackend(pace=True, device=device)
    print(f"tpu_sdr_torch GUI on http://localhost:{port} ({backend.device})"
          + (" (IQ source)" if iq else ""))
    if iq:
        # complex baseband demo: tones above AND below DC
        from tpu_sdr_torch.runtime.source import SyntheticSource

        backend.source = SyntheticSource(
            tones_hz=((150_000.0, 0.5), (-300_000.0, 0.25)),
            noise=0.01,
            iq=True,
        )
    serve(backend, port=port)
