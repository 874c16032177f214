"""Minimal HTTP classification server over the port's serving stack
(counterpart of the JAX package's ``examples/serve.py``; stdlib only).

POST raw JPEG/PNG bytes to /classify and get top-k JSON back; GET /stats
gives the request-latency percentiles (and the micro-batcher's counts).
The native decoder (data/native/decode.cpp) turns the upload into a square
uint8 image on the host, PIL with the same geometry where it cannot;
``Predictor`` runs the padded fixed-shape forward with on-device
preprocessing and top-k, so only (B, k) values come back from the card.
With ``--batch > 1`` concurrent requests coalesce in a ``MicroBatcher``.

    python -m jittor_mlp_tpu_torch.examples.serve --model convmlp_s --pretrained --port 8000 &
    curl -s --data-binary @cat.jpg localhost:8000/classify

``make_server(args)`` builds the server without starting it (port 0 picks a
free port; ``server.server_address`` has it); ``main`` serves forever.
Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import io
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class _Server(ThreadingHTTPServer):
    """socketserver's default listen backlog is 5: a burst of more clients
    than that has its connections refused and retried a second later."""

    request_queue_size = 128
    daemon_threads = True


def parse_args(argv=None):
    import jittor_mlp_tpu_torch as jt

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="MLPMixerForImageClassification",
                    choices=[n for n in jt.__all__
                             if n not in ("Model", "MicroBatcher", "Predictor", "config")])
    ap.add_argument("--pretrained", action="store_true")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--top-k", type=int, default=5)
    ap.add_argument("--int8", action="store_true",
                    help="serve through the dynamic W8A8 int8 path (the W8A8 block kernels)")
    ap.add_argument("--max-delay-ms", type=float, default=2.0,
                    help="micro-batching deadline: concurrent requests coalesce into one "
                         "fixed-shape forward, waiting at most this long for the batch to "
                         "fill (active when --batch > 1)")
    ap.add_argument("--in-flight", type=int, default=4,
                    help="padded batches kept in flight concurrently")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def decode(body, size):
    """(1, size, size, 3) uint8 from encoded image bytes: the native decoder,
    else (or where it fails) PIL with the same geometry."""
    from jittor_mlp_tpu_torch.data.dataset import pil_square
    from jittor_mlp_tpu_torch.data.loader import decode_available, decode_batch

    if decode_available():
        imgs, fail = decode_batch([body], size)
        if not fail[0]:
            return imgs
    return pil_square(io.BytesIO(body), size)[None]


def make_server(args, model=None):
    """(server, predictor, batcher) for parsed ``args``, not yet serving.
    ``model``: serve this model instead of building ``args.model`` (sized
    to ``--image-size``, or ``pretrained=True``). ``batcher`` is None unless
    ``--batch > 1``. Stop with ``server.shutdown()``, ``server.server_close()``
    and ``batcher.close()``."""
    import jittor_mlp_tpu_torch as jt
    from jittor_mlp_tpu_torch.utils import sized_kwargs

    if model is None:
        factory = getattr(jt, args.model)
        kwargs = ({"pretrained": True} if args.pretrained  # published weights fix the size
                  else sized_kwargs(factory, image_size=args.image_size))
        model = factory(**kwargs, device=args.device)
    pred = jt.Predictor(model, batch_size=args.batch, image_size=args.image_size,
                        top_k=args.top_k, compute="int8" if args.int8 else None).warmup()
    batcher = (jt.MicroBatcher(pred, max_delay_ms=args.max_delay_ms, in_flight=args.in_flight)
               if args.batch > 1 else None)

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, obj):
            blob = json.dumps(obj).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)

        def do_GET(self):
            if self.path != "/stats":
                self.send_error(404)
                return
            stats = dict(pred.latency_stats())
            if batcher is not None:
                stats["batcher"] = batcher.stats()
            self._reply(stats)

        def do_POST(self):
            if self.path != "/classify":
                self.send_error(404)
                return
            try:
                body = self.rfile.read(int(self.headers["Content-Length"]))
                img = decode(body, args.image_size)
                if batcher is not None:
                    labels, probs = batcher.submit(img[0])
                else:
                    labels, probs = pred.predict(img)
                    labels, probs = labels[0], probs[0]
                self._reply({"top_k": [{"label": int(lab), "prob": float(p)}
                                       for lab, p in zip(labels, probs)]})
            except Exception as e:
                # one line only: the message derives from request bytes (no
                # response splitting)
                msg = str(e).splitlines()[0][:120] if str(e) else "bad request"
                self.send_error(400, "bad request", msg)

        def log_message(self, *a):
            pass

    # handler threads block in batcher.submit while the dispatcher packs
    # them into one device batch
    server = _Server(("127.0.0.1", args.port), Handler)
    return server, pred, batcher


def main(argv=None):
    from jittor_mlp_tpu_torch.data.loader import decode_available

    args = parse_args(argv)
    server, _pred, batcher = make_server(args)
    print(f"{args.model} ready on :{server.server_address[1]} "
          f"(native decode: {decode_available()}, "
          f"micro-batching: {'on' if batcher else 'off'})", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        if batcher is not None:
            batcher.close()


if __name__ == "__main__":
    main()
