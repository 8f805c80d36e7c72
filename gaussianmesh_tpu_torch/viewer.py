"""Live HTTP viewer (port of `gaussianmesh_tpu/viewer.py`): the remote-viewer
counterpart of the reference's SIBR socket protocol
(gaussian_renderer/network_gui.py:25-60, unused there).

A daemon thread serves plain HTTP: `GET /` an orbit-control page (drag to
rotate, wheel to zoom), `GET /frame?theta=&phi=&r=&w=&h=` a PNG rendered by
a user-supplied `render_fn(camera)`, `GET /state` the frame size and the
count of frames served; anything else is a 404, and a render that raises is
a 500 with its error text. One lock serializes the renders: one card, no
piled-up device work.

`editor_render_fn` serves a `SceneEditor`. Its render runs on the server's
request thread: every tensor names the editor's device, and the image is
copied to the host (`.cpu()`, which waits for the card) before it is
encoded, with the port's own PNG encoder (`io/png.py`; the JAX viewer used
imageio). `ViewerServer.frame_ms` keeps each served frame's render and
encode times on the host clock.
"""

from __future__ import annotations

import json
import math
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from gaussianmesh_tpu_torch.cli.common import to_uint8
from gaussianmesh_tpu_torch.data.cameras import Camera
from gaussianmesh_tpu_torch.edit.pose_paths import _look_at
from gaussianmesh_tpu_torch.io import png
from gaussianmesh_tpu_torch.utils import graphics

_PAGE = """<!doctype html>
<html><head><title>gaussianmesh viewer</title><style>
 body { margin:0; background:#111; color:#ddd; font:13px monospace; }
 #hud { position:fixed; top:8px; left:8px; }
 img { display:block; margin:0 auto; cursor:grab; }
</style></head><body>
<div id="hud">drag: orbit &middot; wheel: zoom</div>
<img id="v" draggable="false">
<script>
let th=0.5, ph=0.3, r=%RADIUS%, busy=false, dirty=true;
const img=document.getElementById('v');
function tick(){
  if(dirty && !busy){
    busy=true; dirty=false;
    const u=`/frame?theta=${th.toFixed(4)}&phi=${ph.toFixed(4)}&r=${r.toFixed(4)}&t=${Date.now()}`;
    const n=new Image();
    n.onload=()=>{img.src=n.src; busy=false;};
    n.onerror=()=>{busy=false;};
    n.src=u;
  }
  requestAnimationFrame(tick);
}
let drag=null;
img.addEventListener('pointerdown',e=>{drag=[e.clientX,e.clientY];});
window.addEventListener('pointerup',()=>{drag=null;});
window.addEventListener('pointermove',e=>{
  if(!drag) return;
  th+=(e.clientX-drag[0])*0.01; ph+=(e.clientY-drag[1])*0.01;
  ph=Math.max(-1.45,Math.min(1.45,ph)); drag=[e.clientX,e.clientY]; dirty=true;
});
window.addEventListener('wheel',e=>{r*=Math.exp(e.deltaY*0.001); dirty=true;});
tick();
</script></body></html>"""


def orbit_camera(theta: float, phi: float, radius: float,
                 width: int, height: int, fovx_deg: float = 60.0,
                 center=(0.0, 0.0, 0.0)) -> Camera:
    """Camera on a sphere around `center` (theta azimuth, phi elevation),
    looking at it."""
    center = np.asarray(center, np.float64)
    pos = center + radius * np.array([math.cos(phi) * math.sin(theta),
                                      math.sin(phi),
                                      math.cos(phi) * math.cos(theta)])
    R, T = _look_at(pos, center)
    fovx = math.radians(fovx_deg)
    fovy = graphics.focal2fov(graphics.fov2focal(fovx, width), height)
    return Camera(uid=0, R=R, T=T, fovx=fovx, fovy=fovy, image=None,
                  width=width, height=height, image_name="viewer")


def encode_png(color) -> bytes:
    """(3, H, W) float [0, 1] on the host -> PNG bytes, quantised as the
    JAX viewer's (`cli.common.to_uint8`)."""
    return png.encode_png(to_uint8(color))


class ViewerServer:
    """Serve interactive renders over HTTP from a daemon thread.

    render_fn(camera: Camera) -> (3, H, W) float image in [0, 1] on the
    host (a CPU tensor or an array). Frame requests are serialized with a
    lock. `frame_ms` lists (render ms, encode ms) per served frame."""

    def __init__(self, render_fn, width: int = 800, height: int = 600,
                 host: str = "127.0.0.1", port: int = 6017,
                 radius: float = 4.0, center=(0.0, 0.0, 0.0),
                 fovx_deg: float = 60.0):
        self.render_fn = render_fn
        self.width, self.height = width, height
        self.radius, self.center, self.fovx_deg = radius, center, fovx_deg
        self._lock = threading.Lock()
        self.frames_served = 0
        self.frame_ms: list[tuple[float, float]] = []
        outer = self

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

            def do_GET(self):
                url = urllib.parse.urlparse(self.path)
                if url.path == "/":
                    page = _PAGE.replace("%RADIUS%", repr(float(outer.radius)))
                    self._send(200, "text/html", page.encode())
                elif url.path == "/frame":
                    q = urllib.parse.parse_qs(url.query)

                    def f(k, d):
                        return float(q.get(k, [d])[0])
                    try:
                        cam = orbit_camera(
                            f("theta", 0.5), f("phi", 0.3), f("r", outer.radius),
                            int(f("w", outer.width)), int(f("h", outer.height)),
                            fovx_deg=outer.fovx_deg, center=outer.center)
                        with outer._lock:
                            t0 = time.perf_counter()
                            color = outer.render_fn(cam)
                            t1 = time.perf_counter()
                            body = encode_png(color)
                            t2 = time.perf_counter()
                            outer.frames_served += 1
                            outer.frame_ms.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3))
                    except Exception as e:  # the server keeps serving; the client sees why
                        self._send(500, "text/plain", str(e).encode())
                    else:
                        self._send(200, "image/png", body)
                elif url.path == "/state":
                    body = json.dumps({
                        "width": outer.width, "height": outer.height,
                        "frames_served": outer.frames_served}).encode()
                    self._send(200, "application/json", body)
                else:
                    self._send(404, "text/plain", b"not found")

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._server.server_address[:2]
        self._thread: threading.Thread | None = None

    def start(self) -> "ViewerServer":
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread:
            self._thread.join(timeout=5)


def editor_render_fn(editor, cfg, bg_color=(0.0, 0.0, 0.0)):
    """render_fn serving a `SceneEditor` (frozen model inspection) at the
    rasterizer capacities of `cfg`, resized to each request's camera. The
    image comes back on the host."""
    bg = torch.tensor(bg_color, dtype=torch.float32, device=editor.device)

    def fn(cam: Camera) -> torch.Tensor:
        frame_cfg = type(cfg)(cam.width, cam.height, cfg.max_per_tile,
                              cfg.pair_capacity_per_gaussian,
                              cfg.row_capacity_per_gaussian)
        with torch.no_grad():
            out = editor.render(cam.arrays(editor.device), frame_cfg, bg_color=bg)
            return out.color.cpu()

    return fn
