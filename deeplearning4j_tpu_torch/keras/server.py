"""Backend server: drive the port from an external (e.g. Keras-side)
client (the JAX package's ``keras/server.py``; the reference's py4j
gateway role played by a plain HTTP / JSON server, stdlib only):

    POST /import   {"path": "model.h5"}              -> {"model_id": ...}
    POST /load     {"path": "model.zip" or ".h5"}    -> {"model_id": ...}
    POST /fit      {"model_id", "features": [...], "labels": [...],
                    "epochs": 1}                     -> {"score": ...}
    POST /predict  {"model_id", "features": [...]}   -> {"output": [...]}
    POST /evaluate {"model_id", "features", "labels"} -> {"accuracy": ...}
    POST /save     {"model_id", "path"}              -> {"path": ...}
    GET  /models                                     -> {"models": [...]}

Arrays travel as nested JSON lists, or as ``features_path`` /
``labels_path`` naming ``.npy`` files. Every model it imports or loads
lives on ``device`` (``None``: the card; ``"cpu"`` for the plain path).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np

from ..ops.platform import resolve_device


class KerasBackendServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 device=None):
        self.device = resolve_device(device)
        self.models: Dict[str, object] = {}
        self._next_id = 0
        self._lock = threading.Lock()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):          # quiet
                pass

            def _reply(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/models":
                    self._reply(200, {"models": list(outer.models)})
                else:
                    self._reply(404, {"error": "unknown endpoint"})

            def do_POST(self):
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    out = outer.handle(self.path, req)
                    self._reply(200, out)
                except Exception as e:        # noqa: BLE001 - to the client
                    self._reply(400, {"error": str(e)})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "KerasBackendServer":
        self._thread.start()
        return self

    def shutdown(self):
        self._httpd.shutdown()
        self._httpd.server_close()

    # ------------------------------------------------------------ handlers
    def _register(self, net) -> str:
        with self._lock:
            mid = f"model_{self._next_id}"
            self._next_id += 1
            self.models[mid] = net
        return mid

    def _net(self, req) -> object:
        net = self.models.get(req.get("model_id", ""))
        if net is None:
            raise ValueError(f"unknown model_id {req.get('model_id')!r}")
        return net

    @staticmethod
    def _array(req, key) -> Optional[np.ndarray]:
        if f"{key}_path" in req:
            return np.load(req[f"{key}_path"], allow_pickle=False)
        if key in req and req[key] is not None:
            return np.asarray(req[key], dtype=np.float32)
        return None

    def handle(self, path: str, req: dict) -> dict:
        from ..ops.dataset import DataSet
        if path == "/import":
            from .importer import KerasModelImport
            net = KerasModelImport.import_keras_model_and_weights(
                req["path"], device=self.device)
            return {"model_id": self._register(net)}
        if path == "/load":
            from ..utils.serializer import ModelGuesser
            return {"model_id": self._register(
                ModelGuesser.load_model_guess_type(req["path"],
                                                   device=self.device))}
        if path == "/fit":
            net = self._net(req)
            ds = DataSet(self._array(req, "features"),
                         self._array(req, "labels"))
            net.fit([ds], num_epochs=int(req.get("epochs", 1)))
            return {"score": float(net.score_value)}
        if path == "/predict":
            net = self._net(req)
            out = net.output(self._array(req, "features"))
            return {"output": np.asarray(out).tolist()}
        if path == "/evaluate":
            net = self._net(req)
            ds = DataSet(self._array(req, "features"),
                         self._array(req, "labels"))
            ev = net.evaluate([ds])
            return {"accuracy": ev.accuracy(), "f1": ev.f1()}
        if path == "/save":
            from ..utils.serializer import ModelSerializer
            ModelSerializer.write_model(self._net(req), req["path"])
            return {"path": req["path"]}
        raise ValueError(f"unknown endpoint {path}")
