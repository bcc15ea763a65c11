"""Micro-batching HTTP inference server for Segtran2d on a CUDA GPU.

Counterpart of ``segtran_tpu/cli/serve.py`` with the same flags (minus
``--scanblocks``, a TPU compile-latency layout) and endpoints:

  POST /segment         image (PNG/JPEG) -> PNG label mask at the input size
  POST /segment?probs=1 -> per-class float probabilities (npy bytes)
  GET  /healthz         liveness + model identity JSON
  GET  /statz           request/batch counters + latency percentiles JSON

Every request is resized to the task's ``orig_input_size`` and batches are
padded to ``--maxbatch``, so the model always sees one shape. Weights move
to the device once, at startup; one worker thread runs the batches under
``torch.inference_mode()``. The model comes from test2d's factory, as in
JAX (``--net segtran``, ``unet-scratch`` with ``--polyformer``, the zoo;
``--mince``); a DA run's checkpoint gives its net. Flags whose modules
belong to a later slice of the port raise NotImplementedError.

Example:
  python -m segtran_tpu_torch.cli.serve --task fundus --bb eff-b4 \\
      --cpdir model/segtran-fundus --iter 7000 --bf16 --fusedepi
"""
from __future__ import annotations

import argparse
import io
import json
import os
import queue
import threading
import time

import numpy as np
import torch

from .. import resolve_device
from ..configs.presets import TASK_SETTINGS
from ..data.stats import load_dataset_stats
from ..infer.sliding import sliding_window_2d
from ..train.checkpoint import load_checkpoint, net_state_dict
from ..utils.misc import setup_logging
from . import test2d


def build_argparser():
    p = argparse.ArgumentParser(
        description="segtran_tpu_torch micro-batching inference server")
    p.add_argument("--task", dest="task_name", default="fundus")
    p.add_argument("--net", default="segtran")
    p.add_argument("--bb", dest="backbone_type", default="eff-b4")
    p.add_argument("--translayers", dest="num_translayers", type=int,
                   default=3)
    p.add_argument("--layercompress", dest="translayer_compress_ratios",
                   default=None)
    p.add_argument("--attractors", dest="num_attractors", type=int,
                   default=256)
    p.add_argument("--noqkbias", dest="qk_have_bias", action="store_false")
    p.add_argument("--nosqueeze", dest="use_squeezed_transformer",
                   action="store_false")
    p.add_argument("--pos", dest="pos_code_type", default="lsinu")
    p.add_argument("--mince", dest="use_mince_transformer",
                   action="store_true")
    p.add_argument("--mincescales", dest="mince_scales", default=None)
    p.add_argument("--minceprops", dest="mince_channel_props", default=None)
    p.add_argument("--infpn", dest="in_fpn_layers", default="34")
    p.add_argument("--outfpn", dest="out_fpn_layers", default="1234")
    p.add_argument("--polyformer", dest="polyformer_mode", default=None,
                   choices=[None, "source", "target"])
    p.add_argument("--cpdir", required=True)
    p.add_argument("--iter", dest="iter_num", type=int, required=True)
    p.add_argument("--origsize", dest="orig_input_size", default=None)
    p.add_argument("--patchsize", dest="patch_size", default=None)
    p.add_argument("--stats", dest="stats_json", default=None)
    p.add_argument("--gray", dest="gray_alpha", type=float, default=0.5)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--fusedepi", dest="use_fused_epilogue",
                   action="store_true",
                   help="CUDA fused output+LN+mode-pool epilogue")
    p.add_argument("--fused", dest="use_fused_attention",
                   action="store_true",
                   help="CUDA flash cross-attention in the squeezed layers")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu; no GPU and no --device cpu "
                        "is an error")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8601)
    p.add_argument("--maxbatch", type=int, default=8,
                   help="padded batch size of every forward")
    p.add_argument("--batchwait", type=float, default=10.0,
                   help="max ms to wait for batch-mates after the first "
                        "request of a batch arrives")
    return p


def build_model_and_config(args, task):
    """The model as JAX's server builds it: test2d's factory (train2d's
    in eval form), which refuses what the port has not reached."""
    return test2d.build_model(args, task)


def task_settings(args):
    task = dict(TASK_SETTINGS[args.task_name])
    for field, override in (("orig_input_size", args.orig_input_size),
                            ("patch_size", args.patch_size)):
        if override:
            vals = tuple(int(v) for v in str(override).split(","))
            task[field] = vals * 2 if len(vals) == 1 else vals
    return task


class _Pending:
    """One enqueued request: input array + completion event + result slot."""

    __slots__ = ("image", "event", "probs", "error", "t_enq")

    def __init__(self, image):
        self.image = image
        self.event = threading.Event()
        self.probs = None
        self.error = None
        self.t_enq = time.perf_counter()


class InferenceEngine:
    """Owns the model on its device and the micro-batching worker."""

    def __init__(self, args, logger):
        self.logger = logger
        self.args = args
        self.device = resolve_device(args.device)
        task = self.task = task_settings(args)
        self.num_classes = task["num_classes"]
        self.orig = tuple(task["orig_input_size"])
        self.patch = tuple(task["patch_size"])

        path = os.path.join(args.cpdir, f"iter_{args.iter_num}")
        if not os.path.isfile(path + ".pt"):
            raise FileNotFoundError(f"checkpoint not found: {path}.pt")
        model, self.cfg = build_model_and_config(args, task)
        model.load_state_dict(
            net_state_dict(load_checkpoint(path, self.cfg)), strict=True)
        self.model = model.to(self.device).eval()   # the one weight upload

        mean, std = load_dataset_stats(args.task_name, args.gray_alpha, "train",
                                       stats_json=args.stats_json)
        f32 = dict(dtype=torch.float32, device=self.device)
        self._mean = torch.tensor(mean, **f32)
        self._std = torch.tensor(std, **f32)
        self._gray_w = torch.tensor([0.299, 0.587, 0.114], **f32)

        self.queue: "queue.Queue" = queue.Queue()
        self.counters = {"requests": 0, "batches": 0, "occupancy_sum": 0}
        self.latencies = []                     # seconds, last 1000
        self.batch_times = []                   # seconds per batch forward
        self._lock = threading.Lock()

        t0 = time.time()
        logger.info("warming up (batch %d, %s) on %s...", args.maxbatch,
                    self.orig, self.device)
        self.forward(np.zeros((args.maxbatch,) + self.orig + (3,), np.float32))
        logger.info("ready in %.1fs; serving", time.time() - t0)
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def _preproc(self, image):
        gray = torch.tensordot(image, self._gray_w, dims=([-1], [0]))[..., None]
        a = self.args.gray_alpha
        return ((1 - a) * image + a * gray - self._mean) / self._std

    def forward(self, batch: np.ndarray) -> np.ndarray:
        """[B, *orig, 3] float32 in [0, 1] -> probs [B, *orig, classes]."""
        # page-locked host buffers on the GPU: a pageable copy of the 32 MB
        # batch of probabilities runs several times slower
        pin = self.device.type == "cuda"
        with torch.inference_mode():
            x = torch.from_numpy(batch)
            x = (x.pin_memory() if pin else x).to(self.device, non_blocking=True)
            probs = sliding_window_2d(
                lambda im: self.model(self._preproc(im)), x, self.orig,
                self.patch, num_classes=self.num_classes)
            # the answers view this block; once they are dropped it goes
            # back to PyTorch's host cache for a later batch
            out = torch.empty(probs.shape, dtype=probs.dtype, pin_memory=pin)
            return out.copy_(probs).numpy()

    def submit(self, image: np.ndarray) -> _Pending:
        """image: [H, W, 3] float32 in [0, 1] at self.orig resolution."""
        p = _Pending(image)
        self.queue.put(p)
        return p

    def close(self) -> None:
        self.queue.put(None)
        self._worker.join()

    def _run(self):
        bmax = self.args.maxbatch
        wait_s = self.args.batchwait / 1e3
        while True:
            first = self.queue.get()
            if first is None:
                return
            batch = [first]
            deadline = time.perf_counter() + wait_s
            stop = False
            while len(batch) < bmax:
                left = deadline - time.perf_counter()
                if left <= 0:
                    break
                try:
                    nxt = self.queue.get(timeout=left)
                except queue.Empty:
                    break
                if nxt is None:
                    stop = True
                    break
                batch.append(nxt)
            arr = np.zeros((bmax,) + self.orig + (3,), np.float32)
            for i, p in enumerate(batch):
                arr[i] = p.image
            t0 = time.perf_counter()
            try:
                probs = self.forward(arr)
                for i, p in enumerate(batch):
                    p.probs = probs[i]
            except Exception as e:              # surface to every waiter
                for p in batch:
                    p.error = e
            now = time.perf_counter()
            with self._lock:
                self.counters["requests"] += len(batch)
                self.counters["batches"] += 1
                self.counters["occupancy_sum"] += len(batch)
                self.batch_times.append(now - t0)
                for p in batch:
                    self.latencies.append(now - p.t_enq)
                del self.latencies[:-1000]
                del self.batch_times[:-1000]
            for p in batch:
                p.event.set()
            if stop:
                return

    def stats(self):
        with self._lock:
            lat = sorted(self.latencies)
            bt = sorted(self.batch_times)
            c = dict(self.counters)

        def pct(vals, q):
            return vals[int(q * (len(vals) - 1))] * 1e3 if vals else None
        return {**c,
                "avg_batch_occupancy": c["occupancy_sum"] / max(c["batches"], 1),
                "latency_ms_p50": pct(lat, 0.5),
                "latency_ms_p95": pct(lat, 0.95),
                "batch_ms_p50": pct(bt, 0.5)}


def make_handler(engine, args):
    from http.server import BaseHTTPRequestHandler
    from PIL import Image

    from ..data.labelmaps import (fundus_inv_map_mask, harden_segmap,
                                  polyp_inv_map_mask)
    task_name = args.task_name

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):
            engine.logger.info("http: " + fmt, *a)

        def _send(self, code, ctype, body):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code, obj):
            self._send(code, "application/json", json.dumps(obj).encode())

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"status": "ok", "net": args.net,
                                 "task": task_name,
                                 "maxbatch": args.maxbatch,
                                 "input_size": list(engine.orig),
                                 "device": str(engine.device)})
            elif self.path == "/statz":
                self._json(200, engine.stats())
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if not self.path.startswith("/segment"):
                self._json(404, {"error": "unknown path"})
                return
            raw = self.rfile.read(int(self.headers.get("Content-Length", 0)))
            try:
                img = Image.open(io.BytesIO(raw)).convert("RGB")
            except Exception as e:
                self._json(400, {"error": f"cannot decode image: {e}"})
                return
            w0, h0 = img.size
            resized = img.resize((engine.orig[1], engine.orig[0]),
                                 Image.BILINEAR)
            pending = engine.submit(np.asarray(resized, np.float32) / 255.0)
            pending.event.wait()
            if pending.error is not None:
                self._json(500, {"error": str(pending.error)})
                return
            if "probs=1" in self.path:
                buf = io.BytesIO()
                np.save(buf, pending.probs)
                self._send(200, "application/octet-stream", buf.getvalue())
                return
            hard = harden_segmap(torch.from_numpy(pending.probs)[None])
            inv = (fundus_inv_map_mask if task_name == "fundus"
                   else polyp_inv_map_mask)
            mask = inv(hard)[0].numpy()
            out = Image.fromarray(mask).resize((w0, h0), Image.NEAREST)
            buf = io.BytesIO()
            out.save(buf, format="PNG")
            self._send(200, "image/png", buf.getvalue())

    return Handler


def _logger(log_dir):
    return setup_logging(log_dir, "serve_log.txt", "segtran_tpu_torch")


def make_server(args, logger=None):
    """Build engine + HTTP server (separate from main() for tests)."""
    from http.server import ThreadingHTTPServer
    engine = InferenceEngine(args, logger or _logger(args.cpdir))
    httpd = ThreadingHTTPServer((args.host, args.port),
                                make_handler(engine, args))
    return httpd, engine


def main(argv=None):
    args = build_argparser().parse_args(argv)
    httpd, engine = make_server(args)
    engine.logger.info("listening on %s:%d", args.host,
                       httpd.server_address[1])
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        engine.close()
    return 0


if __name__ == "__main__":
    main()
