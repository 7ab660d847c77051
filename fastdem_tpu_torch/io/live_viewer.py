"""Live map viewer: browser-based streaming 3D inspection over HTTP (port
of ``fastdem_tpu/io/live_viewer.py``).

A ``ThreadingHTTPServer`` on a daemon thread serves the orbit viewer of
``io.html_viewer``; the page polls ``/frame`` (sequence-gated JSON) for the
latest map, so the browser follows the mapping session as it runs.

    lv = LiveViewer(port=8787).start()
    lv.publish(geom, mapper.state)     # any time a new map is ready
    lv.stop()

Endpoints:
  /        the viewer page (the renderer of io.html_viewer)
  /frame   latest frame: {"seq": N, "meta": {...}, "z": "<base64 u16>"}
           With ?seq=N the reply is {"seq": N} when no newer frame exists,
           so the 5 Hz poll costs nothing when idle.
"""

from __future__ import annotations

import base64
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from fastdem_tpu_torch.grid.gridmap import layers as L
from fastdem_tpu_torch.interop import to_host
from fastdem_tpu_torch.io.html_viewer import _PAGE, encode_frame, encode_points

_LIVE_DATA_JS = """
let seq = -1;
async function poll(){
  try {
    const r = await fetch("/frame?seq=" + seq);
    const f = await r.json();
    if (f.meta !== undefined && f.seq !== seq) {
      seq = f.seq;
      decodeFrame(f.meta, f.z, f.p);
      draw();
    }
  } catch (e) { /* server gone; keep trying */ }
  setTimeout(poll, 200);
}
addEventListener("load", poll);
"""


class LiveViewer:
    """Threaded HTTP server streaming quantized map frames to a browser."""

    def __init__(
        self,
        port: int = 8787,
        host: str = "127.0.0.1",
        layer: str = L.elevation,
        max_cells: int = 160_000,
        z_exaggeration: float = 1.5,
    ):
        self.host = host
        self.port = port
        self.layer = layer
        self.max_cells = max_cells
        self.z_exaggeration = z_exaggeration
        self._lock = threading.Lock()
        self._frame_json: Optional[bytes] = None
        self._seq = 0
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- publishing ---------------------------------------------------------
    def publish(
        self, geom, state, title: str = "elevation (live)",
        scan_xyz=None,
    ) -> int:
        """Encode the current map into the latest frame; returns its seq.

        ``scan_xyz``: optional [N, 3] WORLD-frame points of the last scan,
        streamed beside the surface so the browser's point view ('m' key)
        shows the incoming cloud. Host-side work (one quantization pass);
        tensors on a device are read once."""
        meta, payload = encode_frame(
            geom, state, self.layer, title, self.max_cells,
            self.z_exaggeration,
        )
        frame = {"meta": meta}
        if scan_xyz is not None and len(scan_xyz):
            host = to_host({"pts": scan_xyz, "pos": state.position})
            pts = np.asarray(host["pts"], dtype=np.float32)
            pos = np.asarray(host["pos"], dtype=np.float32)
            # Viewer frame: +x along rows from map center (row -> -x world
            # convention, grid/geometry.py index_of), cell-center aligned.
            view = np.stack(
                [
                    pos[0] - pts[:, 0] - geom.resolution / 2,
                    pos[1] - pts[:, 1] - geom.resolution / 2,
                    pts[:, 2],
                ],
                axis=1,
            )
            pmeta, ppayload = encode_points(view)
            meta["pts"] = pmeta
            frame["p"] = base64.b64encode(ppayload).decode("ascii")
        with self._lock:
            self._seq += 1
            frame["seq"] = self._seq
            frame["z"] = base64.b64encode(payload).decode("ascii")
            self._frame_json = json.dumps(frame).encode()
            return self._seq

    def sink(self, geom):
        """Driver-sink adapter for the 'map' topic: the driver's payload
        carries numpy layers (runtime/driver.py::_viz_loop); wrap them in a
        layers-bearing shim and publish."""
        from types import SimpleNamespace

        def _cb(payload):
            lyr = payload.get("layers")
            if lyr and self.layer in lyr:
                self.publish(
                    geom,
                    SimpleNamespace(
                        layers=lyr,
                        position=payload.get("position", (0.0, 0.0)),
                    ),
                    scan_xyz=payload.get("scan_xyz"),
                )

        return _cb

    # -- server lifecycle ----------------------------------------------------
    def start(self) -> "LiveViewer":
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, body, ctype):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                url = urlparse(self.path)
                if url.path in ("/", "/index.html"):
                    page = _PAGE.replace("__DATA_JS__", _LIVE_DATA_JS)
                    self._send(200, page.encode(), "text/html")
                elif url.path == "/frame":
                    qs = parse_qs(url.query)
                    try:
                        have = int(qs.get("seq", ["-1"])[0])
                    except ValueError:
                        have = -1
                    with viewer._lock:
                        seq, frame = viewer._seq, viewer._frame_json
                    if frame is None or seq == have:
                        self._send(
                            200,
                            json.dumps({"seq": seq}).encode(),
                            "application/json",
                        )
                    else:
                        self._send(200, frame, "application/json")
                else:
                    self._send(404, b"not found", "text/plain")

        self._server = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._server.server_address[1]  # resolve port=0
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="fastdem-live-viewer",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/"
