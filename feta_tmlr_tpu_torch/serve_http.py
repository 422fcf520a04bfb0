"""A JSON-over-HTTP inference endpoint over `serve.Predictor` (stdlib
only: `http.server.ThreadingHTTPServer`).

  POST /predict   {"graphs": [{"x": [[...]...] or "x_int": [...],
                               "edge_index": [[s...],[t...]],
                               "edge_type": [...] (opt), "pe": [[...]] (opt),
                               "lap_pe": [[...]] (opt), "degree": [...] (opt)},
                              ...]}
              ->  {"logits": [[...], ...]}
  GET  /healthz   -> {"status": "ok", "requests": N}

Batching, bucketing and the window of chunks in flight are the
Predictor's (serve.py); this layer decodes JSON graphs, runs an optional
server-side `preprocess(graphs)` (the model's positional encodings), and
encodes the logits. A malformed request gets a 400 and the server keeps
serving. Start it with `serve_forever(predictor, port=...)`, or
`start_background(...)` on a daemon thread; bind to 127.0.0.1 with port 0
and read the bound port back from the server.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from feta_tmlr_tpu_torch.data.batch import Graph

_STATS_LOCK = threading.Lock()


def _graph_from_json(obj: dict) -> Graph:
    if "x_int" in obj:                       # categorical ids variant
        x = np.asarray(obj["x_int"], dtype=np.int32)
        if x.ndim == 1:                      # flat id list -> [n, 1]
            x = x[:, None]
    else:
        x = np.asarray(obj["x"], dtype=np.float32)
    edge_index = np.asarray(obj.get("edge_index", [[], []]),
                            dtype=np.int32).reshape(2, -1)
    opt = lambda k, dt=np.float32: (
        np.asarray(obj[k], dtype=dt) if k in obj else None)
    return Graph(x=x, edge_index=edge_index, pe=opt("pe"),
                 lap_pe=opt("lap_pe"), degree=opt("degree"),
                 edge_type=opt("edge_type", np.int32),
                 edge_attr=opt("edge_attr"))


class _Handler(BaseHTTPRequestHandler):
    predictor = None          # set by make_server
    stats = None
    preprocess = None         # optional fn(graphs)->None (PE precompute)

    def log_message(self, fmt, *args):       # silence default stderr spam
        pass

    def _reply(self, code: int, payload: dict):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/healthz":
            self._reply(200, {"status": "ok",
                              "requests": self.stats["requests"]})
        else:
            self._reply(404, {"error": "unknown path"})

    def do_POST(self):
        if self.path != "/predict":
            self._reply(404, {"error": "unknown path"})
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
            payload = json.loads(self.rfile.read(length) or b"{}")
            graphs = [_graph_from_json(g)
                      for g in payload.get("graphs", [])]
            if self.preprocess is not None:
                # server-side PE precompute: clients send raw graphs,
                # the model's positional encodings are derived here
                self.preprocess(graphs)
            logits = self.predictor.predict(graphs)
            if logits.dtype == object:       # ragged node-level outputs
                out = [np.asarray(row).tolist() for row in logits]
            else:
                out = np.asarray(logits).tolist()
            with _STATS_LOCK:        # handler threads share the counter
                self.stats["requests"] += 1
            self._reply(200, {"logits": out})
        except Exception as e:               # surface as a 400, keep serving
            self._reply(400, {"error": f"{type(e).__name__}: {e}"})


class _Server(ThreadingHTTPServer):
    """ThreadingHTTPServer with a listen backlog of 128 connections. The
    stdlib's 5 overflows when more clients connect at once than the accept
    loop has taken, which the handler threads (holding the GIL through a
    forward) hold up: the kernel then resets the connections past it."""

    request_queue_size = 128


def make_server(predictor, host: str = "127.0.0.1",
                port: int = 0, preprocess=None) -> ThreadingHTTPServer:
    """Build (without starting) the HTTP server; port=0 picks a free one
    (read it back from `server.server_address[1]`)."""
    handler = type("Handler", (_Handler,),
                   {"predictor": predictor, "stats": {"requests": 0},
                    "preprocess": staticmethod(preprocess)
                    if preprocess else None})
    return _Server((host, port), handler)


def serve_forever(predictor, host: str = "127.0.0.1",
                  port: int = 8000, preprocess=None) -> None:
    srv = make_server(predictor, host, port, preprocess)
    print(f"serving on http://{host}:{srv.server_address[1]}")
    srv.serve_forever()


def start_background(predictor, host: str = "127.0.0.1",
                     port: int = 0, preprocess=None):
    """Start on a daemon thread; returns (server, port). `server.shutdown()`
    stops it."""
    srv = make_server(predictor, host, port, preprocess)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv, srv.server_address[1]
