"""Minimal HTTP inference server over an exported serving-artifact dir —
``python -m movae_tpu_torch.serve_artifacts``.

The counterpart of the repo's ``scripts/serve_artifacts.py``: train ->
export (``python -m movae_tpu_torch.export_serving``) -> serve. The server
needs only ``torch``, numpy and ``movae_tpu_torch.kernels``
(``serving.load_serving``: no model module, no checkpoint).

    python -m movae_tpu_torch.serve_artifacts --artifacts ./served_model \\
        --port 8432

Endpoints (arrays travel as .npy bytes, application/octet-stream):

  GET  /healthz            -> {"ok": true, "functions": [...]}
  GET  /manifest           -> manifest.json
  POST /reconstruct        body: uint8 NHWC .npy   -> float32 NHWC .npy
  POST /encode_codes       body: uint8 NHWC .npy   -> int32 codes .npy
                           (hierarchical: .npz with top/bottom)
  POST /decode_codes       body: int32 codes .npy (or .npz top/bottom)
                           -> float32 NHWC .npy
  POST /sample?seed=N      -> float32 NHWC .npy (the export's batch)

One request at a time: the card runs one program after another anyway.
"""

from __future__ import annotations

import argparse
import io
import json
from http.server import BaseHTTPRequestHandler, HTTPServer
from typing import Optional, Sequence

import numpy as np


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def npy_bytes(*arrays) -> bytes:
    """Arrays as a body: one ``.npy``, or a (top, bottom) ``.npz``."""
    buf = io.BytesIO()
    if len(arrays) == 1:
        np.save(buf, _numpy(arrays[0]))
    else:  # hierarchical code pairs
        np.savez(buf, top=_numpy(arrays[0]), bottom=_numpy(arrays[1]))
    return buf.getvalue()


def load_body(body: bytes) -> tuple:
    """.npy -> (array,); .npz -> (top, bottom)."""
    buf = io.BytesIO(body)
    if body[:4] == b"PK\x03\x04":  # zip magic = .npz
        z = np.load(buf)
        return (z["top"], z["bottom"])
    return (np.load(buf, allow_pickle=False),)


def make_handler(fns, manifest):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, payload: bytes,
                  ctype="application/octet-stream"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def _send_json(self, code, obj):
            self._send(code, json.dumps(obj).encode(), "application/json")

        def log_message(self, fmt, *args):  # quiet default access log
            pass

        def do_GET(self):
            path = self.path.split("?")[0]
            if path == "/healthz":
                self._send_json(200, {"ok": True, "functions": sorted(fns)})
            elif path == "/manifest":
                self._send_json(200, manifest)
            else:
                self._send_json(404, {"error": f"no route {path}"})

        def do_POST(self):
            path, _, query = self.path.partition("?")
            name = path.strip("/")
            if name not in fns:
                self._send_json(404, {"error": f"no function {name}",
                                      "functions": sorted(fns)})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                if name == "sample":
                    seed = 0
                    for kv in query.split("&"):
                        if kv.startswith("seed="):
                            seed = int(kv.split("=", 1)[1])
                    out = fns["sample"](seed)
                else:
                    out = fns[name](*load_body(body))
                out = out if isinstance(out, (tuple, list)) else (out,)
                self._send(200, npy_bytes(*out))
            except Exception as e:  # surface the real contract violation
                self._send_json(400, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def serve(artifacts: str, host: str, port: int) -> HTTPServer:
    from movae_tpu_torch.serving import load_manifest, load_serving

    fns = load_serving(artifacts)
    return HTTPServer((host, port), make_handler(fns,
                                                 load_manifest(artifacts)))


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--artifacts", required=True,
                    help="exported serving dir (movae_tpu_torch."
                    "export_serving)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8432)
    args = ap.parse_args(argv)
    httpd = serve(args.artifacts, args.host, args.port)
    print(f"serving {args.artifacts} on http://{args.host}:{args.port} "
          f"(endpoints: /healthz /manifest + POST per function)")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()


if __name__ == "__main__":
    main()
