"""Training UI web server: the JAX package's ``ui/server.py`` (reference
deeplearning4j-play PlayUIServer with its UIModule routes: train
overview / model / system / flow tabs, the remote receiver and the t-SNE
module).

stdlib http.server: JSON endpoints over a StatsStorage plus single-page
views rendering score and throughput charts (inline SVG, no external
assets). Every tab carries a session selector, so earlier attached
sessions stay reachable. :class:`JsonHTTPHandler` and
:class:`BackgroundHTTPServer` are the base the telemetry endpoint
(``observability/telemetry.py``) serves on too. Vectors uploaded to
``/tsne/upload`` are embedded with the port's t-SNE on the server's
``device`` (``None``: the CUDA card).

    UIServer.get_instance().attach(storage)   # then open http://host:9000
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse


class JsonHTTPHandler(BaseHTTPRequestHandler):
    """HTTP plumbing for the port's servers (this training UI,
    ``observability/telemetry.py``):
    quiet request logging plus typed response senders. Subclasses implement
    ``do_GET`` / ``do_POST``."""

    def log_message(self, *args):
        pass

    def _send(self, body: bytes, ctype: str, code: int = 200) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, payload, code: int = 200) -> None:
        self._send(json.dumps(payload).encode(), "application/json", code)

    def _html(self, page: str) -> None:
        self._send(page.encode(), "text/html")

    def _js(self, script: str) -> None:
        self._send(script.encode(), "application/javascript")

    def _text(self, body: str, ctype: str = "text/plain") -> None:
        self._send(body.encode(), ctype)


class BackgroundHTTPServer:
    """A ThreadingHTTPServer on a daemon thread with start() / stop(): bind,
    resolve the ephemeral port, serve in the background, shut down
    cleanly."""

    def __init__(self, handler_cls, host: str = "0.0.0.0", port: int = 0):
        self.handler_cls = handler_cls
        self.host = host
        self.port = int(port)
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "BackgroundHTTPServer":
        if self._server is None:
            self._server = ThreadingHTTPServer((self.host, self.port),
                                               self.handler_cls)
            self.port = self._server.server_address[1]
            self._thread = threading.Thread(
                target=self._server.serve_forever, daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    @property
    def url(self) -> str:
        host = "127.0.0.1" if self.host == "0.0.0.0" else self.host
        return f"http://{host}:{self.port}"


_CHART_JS = """
function draw(svgId, xs, ys, cls) {
  const svg = document.getElementById(svgId);
  svg.innerHTML = '';
  if (xs.length < 2) return;
  const W = svg.clientWidth, H = svg.clientHeight, P = 30;
  const xmin = Math.min(...xs), xmax = Math.max(...xs);
  const ymin = Math.min(...ys), ymax = Math.max(...ys);
  const sx = x => P + (x - xmin) / (xmax - xmin || 1) * (W - 2 * P);
  const sy = y => H - P - (y - ymin) / (ymax - ymin || 1) * (H - 2 * P);
  const d = 'M' + xs.map((x, i) => sx(x) + ',' + sy(ys[i])).join(' L');
  svg.innerHTML =
    `<line class=axis x1=${P} y1=${H - P} x2=${W - P} y2=${H - P}/>` +
    `<line class=axis x1=${P} y1=${P} x2=${P} y2=${H - P}/>` +
    `<path class=${cls} d="${d}"/>` +
    `<text x=${P} y=12 font-size=11>${ymax.toPrecision(4)}</text>` +
    `<text x=${P} y=${H - P + 14} font-size=11>${ymin.toPrecision(4)}</text>`;
}
"""

_SESSIONS_JS = """
// Shared session selector (reference TrainModule keeps a session id per
// view): populates <select id=sesssel>, remembers the choice, and calls
// render(session) on load and on change. Earlier sessions stay reachable.
const esc = s => String(s).replace(/[&<>"']/g, c => ({'&':'&amp;',
  '<':'&lt;','>':'&gt;','"':'&quot;',"'":'&#39;'}[c]));
async function initSessions(render) {
  const sel = document.getElementById('sesssel');
  const sessions = await (await fetch('/train/sessions')).json();
  if (!sessions.length) return;
  const prev = sel.value;
  sel.innerHTML = sessions.map(s =>
    `<option value="${encodeURIComponent(s)}">${esc(s)}</option>`).join('');
  sel.value = sessions.map(encodeURIComponent).includes(prev)
    ? prev : encodeURIComponent(sessions[sessions.length - 1]);
  if (!sel.dataset.bound) {
    sel.dataset.bound = '1';
    sel.addEventListener('change', () => render(sel.value));
  }
  render(sel.value);
}
"""

_NAV = ('<div class=nav><a href="/train">overview</a> '
        '<a href="/train/model.html">model</a> '
        '<a href="/train/system.html">system</a> '
        '<a href="/train/flow.html">flow</a> '
        '<a href="/train/activations.html">activations</a> '
        '<a href="/train/histograms.html">histograms</a> '
        '&nbsp; session: <select id=sesssel></select></div>')

_STYLE = """
body{font-family:sans-serif;margin:20px;background:#fafafa}
h1{font-size:20px} .card{background:#fff;border:1px solid #ddd;
border-radius:6px;padding:12px;margin:12px 0}
.nav{margin:8px 0;font-size:13px} .nav a{margin-right:10px}
svg{width:100%;height:220px} .axis{stroke:#999;stroke-width:1}
.line{fill:none;stroke:#d7301f;stroke-width:1.5}
.line2{fill:none;stroke:#2b8cbe;stroke-width:1.5}
table{border-collapse:collapse} td,th{border:1px solid #ccc;padding:4px 8px}
"""

_PAGE = """<!DOCTYPE html>
<html><head><title>tpu-dl4j training UI</title>
<style>""" + _STYLE + """</style></head><body>
<h1>Training overview</h1>
""" + _NAV + """
<div class=card><table id=info></table></div>
<div class=card><b>Score vs iteration</b><svg id=score></svg></div>
<div class=card><b>Iterations/sec</b><svg id=rate></svg></div>
<script src="/train/chart.js"></script>
<script src="/train/sessions.js"></script>
<script>
async function render(s) {
  const info = await (await fetch('/train/info?session=' + s)).json();
  if (info) {
    document.getElementById('info').innerHTML =
      `<tr><th>model</th><td>${esc(info.model_class)}</td></tr>` +
      `<tr><th>params</th><td>${esc(info.num_params)}</td></tr>` +
      `<tr><th>layers</th><td>${esc(info.num_layers)}</td></tr>`;
  }
  const ups = await (await fetch('/train/updates?session=' + s)).json();
  draw('score', ups.map(u => u.iteration), ups.map(u => u.score), 'line');
  const rated = ups.filter(u => u.iterations_per_sec);
  draw('rate', rated.map(u => u.iteration),
       rated.map(u => u.iterations_per_sec), 'line2');
}
function refresh(){ initSessions(render); }
refresh(); setInterval(refresh, 2000);
</script></body></html>"""


_MODEL_PAGE = """<!DOCTYPE html>
<html><head><title>Model graph</title>
<style>""" + _STYLE + """
.layer{display:inline-block;border:1px solid #2b8cbe;border-radius:4px;
margin:4px;padding:6px 10px;background:#eef6fb;font-size:12px}
.layer b{display:block} .arrow{color:#999;margin:0 2px}
table{font-size:12px} td,th{padding:3px 8px}</style></head><body>
<h1>Model</h1>
""" + _NAV + """
<div class=card id=graph></div>
<div class=card><b>Per-parameter mean |value|</b><table id=mags></table></div>
<script src="/train/sessions.js"></script>
<script>
async function render(s){
  const m = await (await fetch('/train/model?session=' + s)).json();
  if (!m || !m.layers) return;
  document.getElementById('graph').innerHTML = m.layers.map(l =>
    `<span class=layer><b>${esc(l.name)}</b>${esc(l.type)}` +
    `${l.inputs && m.is_graph ? '<br>&larr; ' + esc(l.inputs.join(', '))
      : ''}</span>` +
    (m.is_graph ? '' : '<span class=arrow>&rarr;</span>')
  ).join('');
  const rows = Object.entries(m.param_mean_magnitudes || {});
  document.getElementById('mags').innerHTML =
    '<tr><th>param</th><th>mean |value|</th></tr>' + rows.map(
      ([k, v]) => `<tr><td>${esc(k)}</td><td>${v.toExponential(3)}</td></tr>`
    ).join('');
}
function refresh(){ initSessions(render); }
refresh(); setInterval(refresh, 5000);
</script></body></html>"""


_SYSTEM_PAGE = """<!DOCTYPE html>
<html><head><title>System</title>
<style>""" + _STYLE + """</style></head><body>
<h1>System</h1>
""" + _NAV + """
<div class=card><b>Process memory (max RSS, MB)</b><svg id=mem></svg></div>
<div class=card><b>Iterations/sec</b><svg id=rate></svg></div>
<script src="/train/chart.js"></script>
<script src="/train/sessions.js"></script>
<script>
async function render(s){
  const sys = await (await fetch('/train/system?session=' + s)).json();
  draw('mem', sys.iterations, sys.max_rss_mb, 'line');
  draw('rate', sys.rate_iterations, sys.iterations_per_sec, 'line2');
}
function refresh(){ initSessions(render); }
refresh(); setInterval(refresh, 3000);
</script></body></html>"""


_HIST_PAGE = """<!DOCTYPE html>
<html><head><title>Histograms</title>
<style>""" + _STYLE + """
.hsvg{height:140px}
</style></head><body>
<h1>Parameter histograms</h1>
""" + _NAV + """
<div id=hists><div class=card>no histogram records — train with a
StatsListener(collect_histograms=True)</div></div>
<script src="/train/sessions.js"></script>
<script>
function esc(x){const d=document.createElement('div');
d.textContent=String(x);return d.innerHTML;}
function bars(h){
  const c = h.counts || [], b = h.bins || [];
  if (!c.length) return '<i>empty</i>';
  const W = 600, H = 120, max = Math.max(...c, 1), bw = W / c.length;
  const rects = c.map((v, i) =>
    `<rect x="${(i*bw).toFixed(1)}" y="${(H - v/max*H).toFixed(1)}"` +
    ` width="${Math.max(bw-1,1).toFixed(1)}"` +
    ` height="${(v/max*H).toFixed(1)}" fill="#2b8cbe"/>`).join('');
  const lo = Number(b[0]).toPrecision(3),
        hi = Number(b[b.length-1]).toPrecision(3);
  return `<svg class=hsvg viewBox="0 0 ${W} ${H+16}"` +
    ` preserveAspectRatio="none">${rects}` +
    `<text x="2" y="${H+12}" font-size="10">${lo}</text>` +
    `<text x="${W-60}" y="${H+12}" font-size="10">${hi}</text></svg>`;
}
async function render(s){
  const d = await (await fetch('/train/histograms?session=' + s)).json();
  const hs = d.param_histograms;
  if (!hs) return;
  document.getElementById('hists').innerHTML =
    `<div class=card><b>iteration ${esc(d.iteration)}</b></div>` +
    Object.keys(hs).sort().map(k =>
      `<div class=card><b>${esc(k)}</b>` +
      (d.param_mean_magnitudes && d.param_mean_magnitudes[k] != null
        ? ` <span style="color:#777;font-size:12px">mean |w| = ` +
          `${Number(d.param_mean_magnitudes[k]).toExponential(2)}</span>`
        : '') + bars(hs[k]) + `</div>`).join('');
}
function refresh(){ initSessions(render); }
refresh(); setInterval(refresh, 3000);
</script></body></html>"""

_FLOW_PAGE = """<!DOCTYPE html>
<html><head><title>Flow</title>
<style>""" + _STYLE + """
.layer{display:inline-block;border:1px solid #8c6bb1;border-radius:4px;
margin:4px;padding:6px 10px;background:#f3eef8;font-size:12px;
text-align:center}
.layer b{display:block}.t{color:#555}.arrow{color:#999;margin:0 2px}
</style></head><body>
<h1>Flow</h1>
""" + _NAV + """
<div class=card id=boxes>no flow records — attach a FlowIterationListener
</div>
<div class=card><b>Score vs iteration (flow records)</b>
<svg id=fscore></svg></div>
<script src="/train/chart.js"></script>
<script src="/train/sessions.js"></script>
<script>
async function render(s){
  const d = await (await fetch('/train/flow?session=' + s)).json();
  if (!d.layers || !d.layers.length) return;
  document.getElementById('boxes').innerHTML = d.layers.map((l, i) =>
    `<span class=layer><b>${esc(l.name)}</b>` +
    `<span class=t>${esc(l.params)} params</span><br>` +
    `<span class=t>${l.time_ms == null ? '–'
      : Number(l.time_ms).toFixed(2) + ' ms'}</span></span>` +
    (i < d.layers.length - 1 ? '<span class=arrow>&rarr;</span>' : '')
  ).join('');
  draw('fscore', d.iterations, d.scores, 'line');
}
function refresh(){ initSessions(render); }
refresh(); setInterval(refresh, 3000);
</script></body></html>"""


_ACTIVATIONS_PAGE = """<!DOCTYPE html>
<html><head><title>Convolutional activations</title>
<style>""" + _STYLE + """
img{image-rendering:pixelated;border:1px solid #ccc}
h3{margin:4px 0;font-size:13px}</style></head><body>
<h1>Convolutional activations</h1>
""" + _NAV + """
<div id=grids></div>
<script src="/train/sessions.js"></script>
<script>
// records arrive over the unauthenticated /remote/receive push: escape
// every interpolated field (same esc() policy as the model tab)
async function render(s){
  let d = await (await fetch('/train/activations?session=' + s)).json();
  let ps = s;
  if (!d.layers){
    // the conv listener records under its own session id (default 'conv');
    // when the SELECTED session has no conv records, show the latest conv
    // records across sessions rather than a permanently blank tab (the
    // server no longer silently substitutes — the page asks explicitly)
    d = await (await fetch('/train/activations')).json();
    ps = '';
    if (!d.layers) return;
  }
  document.getElementById('grids').innerHTML = d.layers.map(l =>
    `<div class=card><h3>layer ${esc(l.layer)} — shape ` +
    `[${esc(l.shape)}] mean ${Number(l.mean).toFixed(3)} ` +
    `std ${Number(l.std).toFixed(3)}</h3>` +
    `<img src="/train/activations.png?session=${esc(ps)}&layer=` +
    `${encodeURIComponent(l.layer)}&it=${encodeURIComponent(d.iteration)}"` +
    ` width="${Number(l.grid_shape && l.grid_shape[1]) * 3 || 64}">` +
    `</div>`).join('');
}
function refresh(){ initSessions(render); }
refresh(); setInterval(refresh, 5000);
</script></body></html>"""


_TSNE_PAGE = """<!DOCTYPE html>
<html><head><title>t-SNE — word vectors</title>
<style>body{font-family:sans-serif;margin:20px;background:#fafafa}
.card{background:#fff;border:1px solid #ddd;border-radius:6px;padding:12px}
svg{width:100%;height:560px}text{font-size:10px;fill:#333}
circle{fill:#2b8cbe}</style></head><body>
<h1>t-SNE</h1><div class=card><svg id=plot></svg></div>
<script>
// corpus tokens are arbitrary strings ('<s>', '<unk>', ...): escape before
// injecting into SVG markup
const esc = s => String(s).replace(/[&<>"']/g, c => ({'&':'&amp;',
  '<':'&lt;','>':'&gt;','"':'&quot;',"'":'&#39;'}[c]));
async function refresh(){
  const d = await (await fetch('/tsne/coords')).json();
  const svg = document.getElementById('plot');
  if (!d.coords || !d.coords.length) { return; }
  const W = svg.clientWidth, H = svg.clientHeight, P = 20;
  const xs = d.coords.map(c => c[0]), ys = d.coords.map(c => c[1]);
  const xmin=Math.min(...xs),xmax=Math.max(...xs);
  const ymin=Math.min(...ys),ymax=Math.max(...ys);
  const sx=x=>P+(x-xmin)/(xmax-xmin||1)*(W-2*P);
  const sy=y=>H-P-(y-ymin)/(ymax-ymin||1)*(H-2*P);
  svg.innerHTML = d.coords.map((c,i)=>
    `<circle cx=${sx(c[0])} cy=${sy(c[1])} r=3></circle>`+
    `<text x=${sx(c[0])+4} y=${sy(c[1])-4}>${esc(d.labels[i]||'')}</text>`
  ).join('');
}
refresh(); setInterval(refresh, 5000);
</script></body></html>"""


class _Handler(JsonHTTPHandler):
    storage = None
    tsne_data = None          # {"labels": [...], "coords": [[x, y], ...]}
    device = None             # where uploaded vectors embed (None: card)

    def _latest_conv_record(self, session: str = ""):
        """Most recent 'convolutional' record — in ``session`` when given
        (the conv listener uses its own session id), else across sessions.
        An explicitly requested session with no conv records returns None
        rather than silently showing another run's activations under the
        selected session id."""
        storage = type(self).storage
        if storage is None:
            return None
        sessions = [session] if session else \
            list(reversed(storage.list_sessions()))
        for sess in sessions:
            for u in reversed(storage.get_updates(sess)):
                if u.get("type") == "convolutional":
                    return u
        return None

    def do_GET(self):
        url = urlparse(self.path)
        q = parse_qs(url.query)
        storage = type(self).storage

        def session_param():
            # parse_qs already percent-decoded the value once; decoding
            # again would corrupt ids containing literal %xx sequences
            return q.get("session", [""])[0]

        if url.path in ("/", "/train", "/train/overview"):
            self._html(_PAGE)
        elif url.path == "/train/sessions":
            self._json(storage.list_sessions() if storage else [])
        elif url.path == "/train/updates":
            session = session_param()
            ups = storage.get_updates(session) if storage else []
            slim = [{k: u.get(k) for k in
                     ("iteration", "score", "iterations_per_sec", "epoch",
                      "timestamp", "max_rss_mb")} for u in ups]
            self._json(slim)
        elif url.path == "/train/info":
            session = session_param()
            info = storage.get_static_info(session) if storage else None
            self._json(info)
        elif url.path == "/train/histograms":
            session = session_param()
            ups = storage.get_updates(session) if storage else []
            hists = [u for u in ups if "param_histograms" in u]
            self._json(hists[-1] if hists else {})
        elif url.path == "/train/model":
            # model-graph tab data (reference play train module's model
            # view): layer/vertex boxes from the stored config_json plus
            # the latest per-parameter magnitudes
            session = session_param()
            info = storage.get_static_info(session) if storage else None
            out = {"layers": [], "is_graph": False,
                   "param_mean_magnitudes": {}}
            if info and info.get("config_json"):
                cfg = json.loads(info["config_json"])
                if "vertices" in cfg:
                    out["is_graph"] = True
                    for name in cfg.get("topological_order",
                                        list(cfg["vertices"])):
                        v = cfg["vertices"][name]
                        layer = v.get("layer") or {}
                        out["layers"].append({
                            "name": name,
                            "type": layer.get("@type", v.get("@type", "?")),
                            "inputs": cfg.get("vertex_inputs",
                                              {}).get(name, []),
                        })
                else:
                    for i, layer in enumerate(cfg.get("layers", [])):
                        out["layers"].append({
                            "name": layer.get("name") or f"layer_{i}",
                            "type": layer.get("@type", "?"),
                            "inputs": [],
                        })
            ups = storage.get_updates(session) if storage else []
            for u in reversed(ups):
                if "param_mean_magnitudes" in u:
                    out["param_mean_magnitudes"] = \
                        u["param_mean_magnitudes"]
                    break
            self._json(out)
        elif url.path == "/train/system":
            # system tab series (reference play train module's system
            # view): process memory + iteration rate over time
            session = session_param()
            ups = storage.get_updates(session) if storage else []
            mem = [(u["iteration"], u["max_rss_mb"]) for u in ups
                   if "max_rss_mb" in u]
            rate = [(u["iteration"], u["iterations_per_sec"]) for u in ups
                    if "iterations_per_sec" in u]
            self._json({
                "iterations": [m[0] for m in mem],
                "max_rss_mb": [m[1] for m in mem],
                "rate_iterations": [r[0] for r in rate],
                "iterations_per_sec": [r[1] for r in rate],
            })
        elif url.path == "/train/flow":
            # flow tab (reference FlowIterationListener's flow view): layer
            # boxes with param counts + per-layer forward timing from the
            # latest flow record, plus the score series
            session = session_param()
            ups = [u for u in (storage.get_updates(session)
                               if storage else [])
                   if u.get("type") == "flow"]
            static = storage.get_static_info(session) if storage else None
            names = (static or {}).get("layers") or []
            out = {"layers": [], "iterations": [], "scores": []}
            if ups:
                last = ups[-1]
                counts = last.get("param_counts") or []
                timings = last.get("layer_timings_ms") or []
                n = max(len(names), len(counts), len(timings))
                for i in range(n):
                    out["layers"].append({
                        "name": names[i] if i < len(names) else f"layer_{i}",
                        "params": counts[i] if i < len(counts) else 0,
                        "time_ms": timings[i] if i < len(timings) else None,
                    })
                pts = [(u["iteration"], u["score"]) for u in ups
                       if u.get("score") is not None]
                out["iterations"] = [p[0] for p in pts]
                out["scores"] = [p[1] for p in pts]
            self._json(out)
        elif url.path == "/train/activations":
            rec = self._latest_conv_record(session_param())
            if rec:
                # pixels travel via /train/activations.png, not the JSON
                # poll — strip the base64 payloads
                rec = dict(rec)
                layers = rec.get("layers", [])
                if not isinstance(layers, list):
                    layers = []
                rec["layers"] = [{k: v for k, v in l.items()
                                  if k != "grid_b64"}
                                 for l in layers if isinstance(l, dict)]
            self._json(rec if rec else {})
        elif url.path == "/train/activations.png":
            import base64

            import numpy as np

            from .png import encode_gray_png
            rec = self._latest_conv_record(session_param())
            try:
                layer = int(q.get("layer", ["-1"])[0])
            except ValueError:
                self.send_response(400)
                self.end_headers()
                return
            entry = None
            layers = (rec or {}).get("layers", [])
            if not isinstance(layers, list):
                layers = []
            for lrec in layers:
                if not isinstance(lrec, dict):
                    continue
                if lrec.get("layer") == layer or layer < 0:
                    entry = lrec
                    break
            if entry is None or "grid_b64" not in entry:
                self.send_response(404)
                self.end_headers()
                return
            # records are remote-pushed: validate structure instead of
            # letting KeyError/ValueError escape the handler
            shape = entry.get("grid_shape")
            try:
                raw = base64.b64decode(entry["grid_b64"], validate=True)
            except (ValueError, TypeError):
                raw = None
            if (raw is None or not isinstance(shape, (list, tuple))
                    or len(shape) != 2
                    or not all(isinstance(s, int) and s > 0 for s in shape)
                    or shape[0] * shape[1] != len(raw)):
                self.send_response(400)
                self.end_headers()
                return
            u8 = np.frombuffer(raw, np.uint8).reshape(shape)
            body = encode_gray_png(u8)
            self.send_response(200)
            self.send_header("Content-Type", "image/png")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif url.path == "/train/chart.js":
            self._js(_CHART_JS)
        elif url.path == "/train/sessions.js":
            self._js(_SESSIONS_JS)
        elif url.path == "/train/model.html":
            self._html(_MODEL_PAGE)
        elif url.path == "/train/system.html":
            self._html(_SYSTEM_PAGE)
        elif url.path == "/train/histograms.html":
            self._html(_HIST_PAGE)
        elif url.path == "/train/flow.html":
            self._html(_FLOW_PAGE)
        elif url.path == "/train/activations.html":
            self._html(_ACTIVATIONS_PAGE)
        elif url.path == "/tsne":
            self._html(_TSNE_PAGE)
        elif url.path == "/tsne/coords":
            self._json(type(self).tsne_data or {"labels": [], "coords": []})
        else:
            self.send_response(404)
            self.end_headers()

    MAX_BODY = 64 * 1024 * 1024       # cap accepted POST bodies
    # bound server-side embedding to what a blocking HTTP handler can serve
    # interactively; bigger vocabularies should call
    # clustering.BarnesHutTsne directly and upload coords
    MAX_TSNE_VECTORS = 20_000

    def _read_json_body(self):
        """Parse the request body as JSON; returns None (and answers 4xx)
        on oversized/malformed input instead of raising in the handler."""
        try:
            length = int(self.headers.get("Content-Length", 0))
        except ValueError:
            length = -1
        if length < 0 or length > self.MAX_BODY:
            self.send_response(413)
            self.end_headers()
            return None
        try:
            body = json.loads(self.rfile.read(length) or b"{}")
        except (ValueError, UnicodeDecodeError):
            body = None
        if not isinstance(body, dict):
            self.send_response(400)
            self.end_headers()
            return None
        return body

    def do_POST(self):
        # remote listener push (reference RemoteReceiverModule /
        # ui-remote-iterationlisteners): POST /remote/receive with a record
        url = urlparse(self.path)
        if url.path == "/remote/receive" and type(self).storage is not None:
            record = self._read_json_body()
            if record is None:
                return
            if record.get("type") == "init":
                type(self).storage.put_static_info(record)
            else:
                type(self).storage.put_update(record)
            self._json({"ok": True})
        elif url.path == "/tsne/upload":
            # reference play tsne module: upload word-vector coordinates.
            # Accepts {"labels", "coords"} directly, or {"labels",
            # "vectors"} — high-dimensional vectors are embedded server-side
            # with Barnes-Hut t-SNE (clustering/tsne.py).
            payload = self._read_json_body()
            if payload is None:
                return
            try:
                coords = payload.get("coords")
                if coords is None and payload.get("vectors"):
                    import numpy as np
                    vecs = np.asarray(payload["vectors"], np.float32)
                    if vecs.ndim != 2 or len(vecs) > self.MAX_TSNE_VECTORS:
                        self.send_response(400)
                        self.end_headers()
                        return
                    if len(vecs) > 2000:
                        # real-vocabulary scale: blocked/sampled BH t-SNE
                        # (never materializes [N, N]; clustering/bhtsne.py)
                        from ..clustering.bhtsne import BarnesHutTsne
                        bh = BarnesHutTsne(
                            perplexity=min(30.0, max(2.0, len(vecs) / 100)),
                            n_iter=350, device=type(self).device)
                        coords = np.asarray(bh.calculate(vecs)).tolist()
                    else:
                        from ..clustering.tsne import Tsne
                        tsne = Tsne(n_components=2,
                                    perplexity=min(15.0,
                                                   max(2.0, len(vecs) / 4)),
                                    n_iter=250, device=type(self).device)
                        coords = np.asarray(tsne.calculate(vecs)).tolist()
            except (ValueError, TypeError):
                self.send_response(400)
                self.end_headers()
                return
            type(self).tsne_data = {"labels": payload.get("labels", []),
                                    "coords": coords or []}
            self._json({"ok": True, "count": len(coords or [])})
        else:
            self.send_response(404)
            self.end_headers()


class UIServer:
    """Singleton server (reference UIServer.getInstance().attach(storage)).
    ``device`` is where ``/tsne/upload`` embeds vectors (``None``: the CUDA
    card, looked up at the upload)."""
    _instance: Optional["UIServer"] = None

    def __init__(self, port: int = 9000, device=None):
        self.port = port
        self.device = device
        self._server: Optional[BackgroundHTTPServer] = None

    @classmethod
    def get_instance(cls, port: int = 9000, device=None) -> "UIServer":
        if cls._instance is None:
            cls._instance = UIServer(port, device)
        return cls._instance

    def attach(self, storage):
        _Handler.storage = storage
        _Handler.device = self.device
        if self._server is None:
            self._server = BackgroundHTTPServer(_Handler,
                                                port=self.port).start()
            self.port = self._server.port
        return self

    def stop(self):
        if self._server is not None:
            self._server.stop()
            self._server = None
        UIServer._instance = None


class RemoteStatsRouter:
    """Client side of the remote listener path (reference
    remote-iterationlisteners' WebReporter): a StatsStorage router that POSTs
    records to a UIServer over HTTP."""

    def __init__(self, url: str):
        self.url = url.rstrip("/") + "/remote/receive"

    def _post(self, record):
        import urllib.request
        req = urllib.request.Request(
            self.url, json.dumps(record).encode(),
            {"Content-Type": "application/json"})
        urllib.request.urlopen(req, timeout=5).read()

    def put_update(self, record):
        self._post(record)

    def put_static_info(self, record):
        self._post(record)
