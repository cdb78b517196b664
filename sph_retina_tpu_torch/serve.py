"""Minimal HTTP inference server for spherical detectors.

One process serving detection over HTTP, answering with per-detection
``{"class_name", "bbox", "score"}`` records (the schema of a TorchServe
mmdet handler and of the JAX package's server).

    python -m sph_retina_tpu_torch.serve cfg.py model-abcd1234.npz --port 8080
    curl -X POST --data-binary @pano.jpg localhost:8080/predict

Endpoints:
- ``GET  /ping``     -> {"status": "ok"}
- ``POST /predict``  -> body = raw image bytes (jpg/png), JSON
  ``{"data": "<base64 of such bytes>"}``, or — with
  ``Content-Type: application/x-npy`` — an ``np.save``d uint8 (H, W, 3)
  array, which needs no image decoder on the serving machine;
  response = list of detection records.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .apis import inference_detector, init_detector


def _decode_body(raw: bytes, ctype: str) -> np.ndarray:
    if ctype.startswith("application/x-npy"):
        img = np.load(io.BytesIO(raw), allow_pickle=False)
        if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(
                f"application/x-npy body must be uint8 (H, W, 3), got "
                f"{img.dtype} {img.shape}")
        return img
    if ctype.startswith("application/json"):
        raw = base64.b64decode(json.loads(raw)["data"])
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))


def make_handler(det, classes, score_thr):
    """The request handler class of one detector.

    ``ThreadingHTTPServer`` gives every request a thread of its own, and
    PyTorch keeps its CUDA and cuDNN state per thread: run in the request's
    thread, every inference would set that state up again (hundreds of
    milliseconds on an H100 host, against ~20 for the inference). So the
    handler threads only read and write HTTP, and one long-lived worker
    thread (``Handler.worker``) runs every inference, one at a time — the
    card is one serial resource anyway. Whoever closes the server calls
    ``Handler.worker.shutdown()``.
    """
    infer = ThreadPoolExecutor(max_workers=1, thread_name_prefix="sph-infer")

    class Handler(BaseHTTPRequestHandler):
        worker = infer

        def _send(self, code, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def do_GET(self):
            if self.path == "/ping":
                self._send(200, {"status": "ok"})
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, {"error": "unknown path"})
                return
            try:
                raw = self.rfile.read(
                    int(self.headers.get("Content-Length", 0)))
                img = _decode_body(raw, self.headers.get("Content-Type", ""))
                result = infer.submit(inference_detector, det, img).result()
                out = []
                for c, dets in enumerate(result):
                    name = classes[c] if classes and c < len(classes) \
                        else str(c)
                    for row in dets:
                        score = float(row[-1])
                        if score >= score_thr:
                            out.append({"class_name": name,
                                        "bbox": [float(v) for v in row[:-1]],
                                        "score": score})
                self._send(200, out)
            except Exception as e:  # noqa: BLE001 - report to the client
                self._send(400, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def main(argv=None):
    p = argparse.ArgumentParser(description="Serve a spherical detector")
    p.add_argument("config")
    p.add_argument("checkpoint", nargs="?", default=None,
                   help="published .npz checkpoint")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--score-thr", type=float, default=0.5)
    p.add_argument("--device", default=None, choices=["cpu", "cuda"],
                   help="default: cuda; fails when there is no card")
    args = p.parse_args(argv)

    det = init_detector(args.config, args.checkpoint, device=args.device)
    classes = det.cfg.get("classes") or det.cfg.get("data", {}).get("classes")
    handler = make_handler(det, classes, args.score_thr)
    # the first call, in the worker's thread, builds the kernel library and
    # sets up cuDNN, so that the first request does not pay for either
    h, w = det.cfg.get("img_size", (512, 1024))
    handler.worker.submit(
        inference_detector, det, np.zeros((h, w, 3), np.uint8)).result()
    server = ThreadingHTTPServer((args.host, args.port), handler)
    print(f"serving on http://{args.host}:{server.server_address[1]} "
          f"(POST /predict, GET /ping)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        handler.worker.shutdown()


if __name__ == "__main__":
    main()
