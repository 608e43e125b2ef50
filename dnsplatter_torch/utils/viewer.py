"""Live training viewer on stdlib HTTP (counterpart of
dnsplatter_tpu/utils/viewer.py).

The reference trains with the nerfstudio viewer on by default, giving live
renders and stats in the browser. This is the self-contained analogue: a
daemon-thread HTTP server that serves

  /            one-page dashboard (auto-refreshing render + metric table,
               orbit-camera controls)
  /rgb.png     latest posted render (also /depth.png, /normal.png)
  /stats.json  latest metric dict
  /render.png?az=<deg>&el=<deg>&r=<radius>&ch=rgb|depth|normal&scale=<s>
               renders the current model from a user-driven orbit pose
               through the `render_fn` the trainer registers.

The trainer posts images and metrics via `update()`. Orbit renders run on
the HTTP thread, serialized by a lock so concurrent requests cannot
interleave device work; a render that raises answers 503 and its traceback
goes to stderr. `render_fn(az, el, radius, scale)` always takes the scale
(the JAX package retried without it on any TypeError, which hid a
TypeError raised inside the render).
"""

from __future__ import annotations

import json
import sys
import threading
import traceback
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

import numpy as np

from dnsplatter_torch.data.io import encode_png

_PAGE = """<!DOCTYPE html>
<html><head><title>dnsplatter_torch viewer</title><style>
body{font-family:monospace;background:#111;color:#ddd;margin:20px}
img{image-rendering:pixelated;border:1px solid #444;max-width:45vw}
table{border-collapse:collapse;margin-top:12px}
td{padding:2px 10px;border:1px solid #333}
</style></head><body>
<h3>dnsplatter_torch live viewer</h3>
<div><img id="rgb" src="/rgb.png"/> <img id="depth" src="/depth.png"/></div>
<div style="margin-top:12px">
  <b>orbit camera</b> — drag to orbit, scroll to zoom
  ch <select id="ch"><option>rgb</option><option>depth</option>
     <option>normal</option></select>
  res <select id="res"><option value="0.5">160px</option>
     <option value="1.0" selected>320px</option>
     <option value="1.5">480px</option></select>
  <span id="pose" style="color:#888"></span>
  <div><img id="orbit" draggable="false"
       style="cursor:grab;touch-action:none;user-select:none"/></div>
</div>
<table id="stats"></table>
<script>
let az=0, el=20, r=3.0, inflight=false, dirty=false;
function orbit(){
  if (inflight){ dirty=true; return; }
  inflight=true;
  const ch=document.getElementById('ch').value,
        res=document.getElementById('res').value,
        img=document.getElementById('orbit');
  document.getElementById('pose').textContent =
    ` az ${az.toFixed(0)} el ${el.toFixed(0)} r ${r.toFixed(1)}`;
  img.onload = img.onerror = () => {
    inflight=false; if (dirty){ dirty=false; orbit(); }
  };
  img.src = `/render.png?az=${az}&el=${el}&r=${r}&ch=${ch}`+
            `&scale=${res}&t=${Date.now()}`;
}
{
  const img=document.getElementById('orbit');
  let drag=false, lx=0, ly=0;
  img.addEventListener('pointerdown', e=>{
    drag=true; lx=e.clientX; ly=e.clientY;
    img.setPointerCapture(e.pointerId); e.preventDefault();
  });
  img.addEventListener('pointermove', e=>{
    if(!drag) return;
    az=((az + (e.clientX-lx)*0.5 + 540) % 360) - 180;
    el=Math.max(-80, Math.min(80, el + (e.clientY-ly)*0.5));
    lx=e.clientX; ly=e.clientY; orbit();
  });
  img.addEventListener('pointerup', ()=>{ drag=false; });
  img.addEventListener('wheel', e=>{
    e.preventDefault();
    r=Math.max(0.5, Math.min(80, r*Math.exp(e.deltaY*0.001)));
    orbit();
  }, {passive:false});
}
for (const id of ['ch','res'])
  document.getElementById(id).addEventListener('change', orbit);
orbit();
async function tick(){
  try{
    const r = await fetch('/stats.json'); const s = await r.json();
    const t = document.getElementById('stats');
    t.innerHTML = Object.entries(s).map(
      ([k,v])=>`<tr><td>${k}</td><td>${typeof v==='number'?v.toFixed(5):v}</td></tr>`
    ).join('');
    for (const id of ['rgb','depth']){
      document.getElementById(id).src = '/'+id+'.png?t='+Date.now();
    }
  }catch(e){}
  setTimeout(tick, 2000);
}
tick();
</script></body></html>"""


class ViewerState:
    def __init__(self):
        self.lock = threading.Lock()
        self.images: Dict[str, bytes] = {}
        self.stats: Dict[str, float] = {}
        # render_fn(azimuth_deg, elevation_deg, radius, scale) -> {name:
        # (H, W, C) array}
        self.render_fn: Optional[Callable] = None
        self.render_lock = threading.Lock()
        self._render_cache: tuple = (None, None)  # (key, images dict)

    def render_pose(self, az: float, el: float, radius: float,
                    channel: str, scale: float = 1.0) -> Optional[bytes]:
        """Render the scene from a user-supplied orbit pose (cached per
        pose, so switching channels does not render again). `scale` is the
        live resolution setting, quantized to 0.5, 1.0 and 1.5."""
        if self.render_fn is None:
            return None
        scale = min((0.5, 1.0, 1.5), key=lambda s: abs(s - scale))
        key = (round(az, 2), round(el, 2), round(radius, 3), scale)
        with self.render_lock:
            if self._render_cache[0] != key:
                imgs = self.render_fn(az, el, radius, scale=scale)
                self._render_cache = (key, imgs)
            imgs = self._render_cache[1]
        arr = imgs.get(channel)
        return None if arr is None else _encode_png(arr)

    def update(self, stats: Optional[Dict] = None,
               images: Optional[Dict[str, np.ndarray]] = None) -> None:
        """Post new metrics and/or (H, W, 3|1) float [0,1] images."""
        with self.lock:
            if stats:
                self.stats.update({
                    k: (float(v) if isinstance(
                        v, (int, float, np.floating, np.integer)) else str(v))
                    for k, v in stats.items()
                })
            if images:
                for name, arr in images.items():
                    self.images[name] = _encode_png(arr)


def _encode_png(arr: np.ndarray) -> bytes:
    """An (H, W, 3) image, or an (H, W[, 1]) depth map normalized to its
    range for display, as an 8-bit PNG."""
    a = np.asarray(arr)
    if a.ndim == 3 and a.shape[-1] == 1:
        a = a[..., 0]
    if a.ndim == 2:
        a = np.nan_to_num(a, nan=0.0, posinf=0.0, neginf=0.0)
        lo, hi = float(a.min()), float(a.max())
        a = np.stack([(a - lo) / max(hi - lo, 1e-9)] * 3, -1)
    return encode_png(a)


class Viewer:
    """viewer = Viewer(port); viewer.update(stats=..., images=...)"""

    def __init__(self, port: int = 7007, host: str = "127.0.0.1"):
        state = ViewerState()
        self.state = state

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence request logging
                pass

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/" or path == "/index.html":
                    body = _PAGE.encode()
                    ctype = "text/html"
                elif path == "/stats.json":
                    with state.lock:
                        body = json.dumps(state.stats).encode()
                    ctype = "application/json"
                elif path == "/render.png":
                    q = urllib.parse.parse_qs(
                        urllib.parse.urlsplit(self.path).query
                    )

                    def fget(k, d):
                        try:
                            return float(q.get(k, [d])[0])
                        except ValueError:
                            return d

                    ch = q.get("ch", ["rgb"])[0]
                    try:
                        body = state.render_pose(
                            fget("az", 0.0), fget("el", 20.0),
                            fget("r", 3.0), ch,
                            scale=fget("scale", 1.0),
                        )
                    except Exception:  # the server keeps serving
                        traceback.print_exc(file=sys.stderr)
                        body = None
                    if body is None:
                        self.send_response(503)
                        self.end_headers()
                        return
                    ctype = "image/png"
                elif path.endswith(".png"):
                    name = path[1:-4]
                    with state.lock:
                        body = state.images.get(name)
                    if body is None:
                        self.send_response(404)
                        self.end_headers()
                        return
                    ctype = "image/png"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

        self.server = ThreadingHTTPServer((host, port), Handler)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(
            target=self.server.serve_forever, daemon=True
        )
        self.thread.start()

    def update(self, stats=None, images=None) -> None:
        self.state.update(stats=stats, images=images)

    def set_render_fn(self, fn) -> None:
        """Register fn(az_deg, el_deg, radius, scale) -> {channel: array}
        for the user-driven /render.png orbit endpoint."""
        self.state.render_fn = fn

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()
