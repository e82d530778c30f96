"""A small HTTP live viewer: the counterpart of the JAX package's
``viewer.py``, the headless form of the reference's browser UI (App.tsx
canvas, controller.ts fly camera, fps-meter).

It serves one self-contained page that polls the progressive render and
forwards WASD and drag input to the ``Controller``; every motion restarts
the accumulation, as the reference's does (renderer.ts:152-201). The render
loop runs on the caller's thread and queues each tick's frames unsynced
(``render(spp, fetch=False, sync=False)``); the frame's PNG pull is the
tick's one wait for the device. The HTTP server is a daemon thread that
touches only the lock-guarded snapshot (the PNG, the stats, the denoise
flag) and the event queue: input and scene loads are queued and applied by
the render thread.

    python -m wgpu_path_tracing_tpu_torch.cli view cornell --port 8080
    # open http://localhost:8080, or drive it headlessly:
    curl 'http://localhost:8080/key?k=w&down=1' ; sleep 1
    curl 'http://localhost:8080/key?k=w&down=0'
    curl -o frame.png http://localhost:8080/frame.png
    # scene swap (App.tsx:12-34): a path on the server or the .glb bytes;
    # the scene is read off the render thread and installed at a chunk
    # boundary (Renderer.load_model_async)
    curl -X POST 'http://localhost:8080/load?path=/path/to/scene.glb'
    curl --data-binary @scene.glb http://localhost:8080/load

The frame is encoded by ``utils/image.py::encode_png`` (the JAX package's
uses Pillow, which this package does not import).
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from wgpu_path_tracing_tpu_torch.render.controller import Controller
from wgpu_path_tracing_tpu_torch.utils.image import encode_png

_PAGE = """<!doctype html>
<html><head><title>tpu-path-tracing</title><style>
body{background:#111;color:#ddd;font:13px monospace;text-align:center}
img{image-rendering:pixelated;width:70vmin;height:70vmin;margin-top:2vmin}
</style></head><body>
<div id=s>connecting...</div>
<img id=v src="/frame.png" draggable=false>
<div>WASD/space/shift to fly &middot; drag to look &middot; wheel to dolly
 &middot; drop a .glb to swap scenes &middot;
 <label><input id=dn type=checkbox> denoise</label></div>
<script>
document.getElementById('dn').addEventListener('change',
 e=>fetch(`/denoise?on=${e.target.checked?1:0}`));
const v=document.getElementById('v'),s=document.getElementById('s');
setInterval(()=>{v.src='/frame.png?'+Date.now();
 fetch('/stats').then(r=>r.json()).then(j=>{
  s.textContent=`${j.spp} spp  ${j.mrays.toFixed(1)} Mrays/s  ${j.fps.toFixed(1)} fps`});},500);
for(const[ev,down]of[['keydown',1],['keyup',0]])
 addEventListener(ev,e=>{const k=e.key===' '?'space':e.key.toLowerCase();
  fetch(`/key?k=${k}&down=${down}`);});
let drag=null;
v.addEventListener('mousedown',e=>drag=[e.clientX,e.clientY]);
addEventListener('mouseup',()=>drag=null);
addEventListener('mousemove',e=>{if(!drag)return;
 fetch(`/look?dx=${e.clientX-drag[0]}&dy=${e.clientY-drag[1]}`);
 drag=[e.clientX,e.clientY];});
v.addEventListener('wheel',e=>{e.preventDefault();
 fetch(`/pinch?d=${-e.deltaY}`);},{passive:false});
// Drag-drop scene swap — the reference's signature flow (App.tsx:12-34).
addEventListener('dragover',e=>e.preventDefault());
addEventListener('drop',e=>{e.preventDefault();
 const f=e.dataTransfer.files[0];if(!f)return;
 s.textContent=`loading ${f.name}...`;
 f.arrayBuffer().then(b=>fetch('/load',{method:'POST',body:b}));});
</script></body></html>"""


def _unlink_quietly(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass


class ViewerServer:
    """Owns the HTTP thread and the shared state; ``step`` is one tick of
    the render loop, ``run_loop`` ticks until ``stop``."""

    def __init__(self, renderer, port: int = 0, frames_per_update: int = 4):
        self.renderer = renderer
        self.controller = Controller(renderer)
        self.frames_per_update = frames_per_update
        self._lock = threading.Lock()
        # Guarded by _lock: the published frame and stats, the denoise flag
        # (GET /denoise?on=1 filters the published copies only) and the
        # queued events.
        self._png = b""
        self._stats: dict = {"spp": 0, "mrays": 0.0, "fps": 0.0,
                             "motion_to_frame_ms": None, "load_error": None}
        self._denoise = False
        self._events: list[tuple] = []
        self._stop = threading.Event()
        # The render thread's own: the wall time from draining a motion
        # event to the next published frame (the accumulation restarted),
        # served as motion_to_frame_ms; the scene loads started (futures of
        # ``load_model_async``) and the last one's failure.
        self._motion_t: float | None = None
        self._motion_to_frame_ms: float | None = None
        self._load_error: str | None = None
        self.loads: list = []

        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, ctype, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def _queue(self, event: tuple):
                with viewer._lock:
                    viewer._events.append(event)
                self._send(200, "text/plain", b"ok")

            def do_GET(self):
                url = urlparse(self.path)
                q = parse_qs(url.query)
                if url.path == "/":
                    self._send(200, "text/html", _PAGE.encode())
                elif url.path == "/frame.png":
                    with viewer._lock:
                        png = viewer._png
                    self._send(200, "image/png", png)
                elif url.path == "/key":
                    k = q.get("k", [""])[0]
                    k = {"space": " ", "shift": "Shift"}.get(k, k)
                    self._queue(("key", k, q.get("down", ["1"])[0] == "1"))
                elif url.path == "/look":
                    self._queue(("look", float(q.get("dx", ["0"])[0]),
                                 float(q.get("dy", ["0"])[0])))
                elif url.path == "/pinch":
                    self._queue(("pinch", float(q.get("d", ["0"])[0])))
                elif url.path == "/denoise":
                    with viewer._lock:
                        viewer._denoise = q.get("on", ["1"])[0] == "1"
                    self._send(200, "text/plain", b"ok")
                elif url.path == "/stats":
                    with viewer._lock:
                        body = json.dumps(viewer._stats).encode()
                    self._send(200, "application/json", body)
                else:
                    self._send(404, "text/plain", b"not found")

            def do_POST(self):
                url = urlparse(self.path)
                if url.path != "/load":
                    self._send(404, "text/plain", b"not found")
                    return
                # A ?path= query names a file on the server; a body is the
                # .glb bytes themselves (the page's drop handler posts
                # them), kept in a temporary file until the load settles.
                path = parse_qs(url.query).get("path", [None])[0]
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n) if n else b""
                tmp_path = None
                if path is None and body:
                    suffix = ".glb" if body[:4] == b"glTF" else ".gltf"
                    fd, tmp_path = tempfile.mkstemp(suffix=suffix)
                    with os.fdopen(fd, "wb") as f:
                        f.write(body)
                    path = tmp_path
                if path is None:
                    self._send(400, "text/plain",
                               b"need ?path= or a .glb body")
                    return
                with viewer._lock:
                    viewer._events.append(("load", path, tmp_path))
                self._send(200, "text/plain", b"staged")

        self.httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    @property
    def denoise(self) -> bool:
        with self._lock:
            return self._denoise

    def _start_load(self, path: str, tmp_path: str | None) -> None:
        """Read a scene off the render thread (``load_model_async``); the
        next render installs it at a chunk boundary. An upload's temporary
        file goes when the load settles."""
        future = self.renderer.load_model_async(path)
        if tmp_path is not None:
            future.add_done_callback(lambda _f: _unlink_quietly(tmp_path))
        self.loads.append(future)

    def _drain_events(self, dt: float) -> None:
        with self._lock:
            events, self._events = self._events, []
        for ev in events:
            if ev[0] == "load":
                self._start_load(ev[1], ev[2])
                continue
            if self._motion_t is None:
                self._motion_t = time.perf_counter()
            if ev[0] == "key":
                (self.controller.key_down if ev[2]
                 else self.controller.key_up)(ev[1])
            elif ev[0] == "pinch":
                self.controller.pinch(ev[1])
            else:
                self.controller.mouse_move(ev[1], ev[2])
        self.controller.update(dt)

    def _render(self) -> None:
        """Queue a chunk of frames; the render installs a staged scene at
        its start or a chunk boundary. A scene load that failed raises from
        there: it is reported in the stats (``load_error``), and the
        current scene renders on at the next tick."""
        try:
            self.renderer.render(spp=self.frames_per_update, fetch=False,
                                 sync=False)
        except RuntimeError as exc:
            cause = exc.__cause__
            if cause is None or not any(
                    f.done() and f.exception() is cause for f in self.loads):
                raise
            self._load_error = str(exc)

    def _snapshot(self) -> None:
        with self._lock:
            denoise = self._denoise
        png = encode_png(self.renderer.image(denoise=denoise))
        if self._motion_t is not None:
            self._motion_to_frame_ms = (
                time.perf_counter() - self._motion_t) * 1e3
            self._motion_t = None
        st = self.renderer.stats()
        stats = {"spp": st["frame_index"], "mrays": st["mrays_per_sec"],
                 "fps": st["frames"]["fps"],
                 "motion_to_frame_ms": self._motion_to_frame_ms,
                 "load_error": self._load_error}
        with self._lock:
            self._png, self._stats = png, stats

    def step(self, dt: float) -> None:
        """One tick (the rAF loop's body, renderer.ts:456-473): apply the
        queued input, queue a chunk of frames, publish the frame."""
        self._drain_events(dt)
        self._render()
        self._snapshot()

    def run_loop(self, max_seconds: float | None = None) -> None:
        t_prev = time.perf_counter()
        t0 = t_prev
        while not self._stop.is_set():
            now = time.perf_counter()
            self.step(now - t_prev)
            t_prev = now
            if max_seconds is not None and now - t0 > max_seconds:
                break

    def stop(self) -> None:
        self._stop.set()
        self.httpd.shutdown()
        self.httpd.server_close()
