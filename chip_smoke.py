#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (segtran_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run:

1. build  -- compile every CUDA source of the port with nvcc (sm_90a), all
   at once; print the card's name and power limit.
2. kernels -- hold each expansion-epilogue kernel against its plain
   PyTorch version at the fundus flagship's shapes (P [8,4,1296,256]; F=1792
   per mode, F=896 and 448 all modes; mid [2,4,1296,896] for the private
   tier) in bf16 and fp32 (TF32 off for fp32), and time both with CUDA
   events.
3. serving -- the InferenceEngine of cli/serve.py at full width (eff-b4,
   3 translayers 1792->1792->896->448, 256 attractors, bf16, --fusedepi,
   576^2 frames through 288^2 patches, --maxbatch 8) from a seeded port
   checkpoint; 16 requests from 4 client threads; the launch counters must
   show 4 per-mode and 2 all-modes launches per forward; one forward is
   profiled (device time by kernel); the same batch through the unfused
   modules must agree.
4. non-reassociated forward at batch 2 -- must launch the private-output
   kernel and agree with the unfused modules.

Before the last line it prints one JSON object with the per-kernel numbers
and the card's ``name, power.limit``; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA GPU, or without the
port's sources beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import shutil
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SERVE_ARGV = ["--task", "fundus", "--net", "segtran", "--bb", "eff-b4",
              "--translayers", "3", "--layercompress", "1,1,2,2",
              "--attractors", "256", "--bf16", "--maxbatch", "8",
              "--batchwait", "10", "--device", "cuda"]
# H100 SXM data sheet: dense bf16 tensor-core and fp32 CUDA-core peaks, HBM
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
PEAK_BYTES = 3.35e12
# kernel vs plain version, as (max of |err| / (1 + |plain|), mean |err|):
# both round at the same points, but their fp32 sums run in other orders,
# which can move a bf16 rounding by one ulp (2^-8 relative) and carry it
# through LayerNorm and the pool; fp32 differs only in summation order
KERNEL_TOL = {"bf16": (3e-2, 4e-3), "fp32": (1e-4, 1e-5)}
# fused vs unfused model, bf16 probabilities in [0, 1]: the two paths round
# at different places (kernel tiles vs PyTorch ops) through three layers
MODEL_TOL = (0.1, 5e-3)                                       # (max, mean)


def log(msg):
    print(msg, flush=True)


def fail(msg):
    raise RuntimeError(msg)


def card_line(torch):
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
        if r.returncode == 0 and r.stdout.strip():
            return r.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired):
        pass
    return f"{torch.cuda.get_device_name(0)}, power limit not readable"


def cuda_ms(torch, fn, iters, warmup=1):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------ phase 2 ----

def epilogue_inputs(torch, kind, b, m, n, a, f, dt, seed):
    """Activations in the compute dtype, parameters in fp32 (as the model
    holds them)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"

    def rn(*shape, s=1.0):
        return torch.randn(*shape, generator=g, device=dev) * s
    # ws at the feat2score init scale, normal(0.02): mode scores of O(1).
    # (At 0.2 the scores reach ~10, and where two modes nearly tie, a
    # one-ulp bf16 flip of a row's LayerNorm scale moves the pool weight by
    # a visible amount, in either version alike.)
    p = dict(w2=rn(m, f, f, s=1 / math.sqrt(f)), b2=rn(m, f, s=0.1),
             scale=torch.rand(f, generator=g, device=dev) + 0.5,
             lnb=rn(f, s=0.1), ws=rn(f, 1, s=0.02), bs=rn(1))
    if kind == "private":
        return [rn(b, m, n, f, s=0.5).to(dt)] + [p[k] for k in (
            "w2", "b2", "scale", "lnb", "ws", "bs")]
    # scaled so that z = mid W2 + b2 has a row spread of ~0.2-0.5, like the
    # LayerNorm inputs of a layer; a much flatter row lets LayerNorm blow
    # a one-ulp bf16 flip of z up to many ulps of l
    probs = torch.softmax(rn(b, m, n, a, s=4.0), dim=-1).to(dt)
    return [probs, rn(b, m, a, f, s=2.0).to(dt), rn(f, s=0.1)] + [
        p[k] for k in ("w2", "b2", "scale", "lnb", "ws", "bs")]


def epilogue_work(kind, b, m, n, a, f, args):
    """(FLOP, bytes): the matrix products of the function, and each input
    read once plus the [B, N, F] output written once."""
    flops = 2 * b * m * n * f * (f if kind == "private" else a + f)
    nbytes = sum(t.numel() * t.element_size() for t in args)
    nbytes += b * n * f * args[0].element_size()
    return flops, nbytes


def check_kernels(torch, epi):
    cases = [("fused_mid_output_pool_permode", "mid", 8, 4, 1296, 256, 1792),
             ("fused_mid_output_pool", "mid", 8, 4, 1296, 256, 896),
             ("fused_mid_output_pool", "mid", 8, 4, 1296, 256, 448),
             ("fused_private_output_pool", "private", 2, 4, 1296, 0, 896)]
    results = []
    for dname, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        # plain fp32 references without TF32: full-precision products
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        for i, (name, kind, b, m, n, a, f) in enumerate(cases):
            args = epilogue_inputs(torch, kind, b, m, n, a, f, dt, seed=i)
            kern = getattr(epi, name)
            plain = getattr(epi, name + "_plain")
            out = kern(*args)
            ref = plain(*args)
            torch.cuda.synchronize()
            if out.shape != (b, n, f) or out.dtype != dt:
                fail(f"{name} {dname}: got {tuple(out.shape)} {out.dtype}")
            err = (out.float() - ref.float()).abs()
            max_err, mean_err = float(err.max()), float(err.mean())
            rel_err = float((err / (1 + ref.float().abs())).max())
            tol_max, tol_mean = KERNEL_TOL[dname]
            ms = cuda_ms(torch, lambda: kern(*args), iters=5)
            plain_ms = cuda_ms(torch, lambda: plain(*args), iters=3)
            flops, nbytes = epilogue_work(kind, b, m, n, a, f, args)
            t_ops, t_bytes = flops / PEAK_FLOPS[dname], nbytes / PEAK_BYTES
            row = dict(name=name, dtype=dname, shape=[b, m, n, a, f],
                       max_abs_err=max_err, mean_abs_err=mean_err,
                       max_rel_err=rel_err,
                       ms=ms, plain_ms=plain_ms,
                       bound_ms=max(t_ops, t_bytes) * 1e3,
                       bound_by="operations" if t_ops >= t_bytes else "bytes",
                       flop=flops, bytes=nbytes)
            results.append(row)
            log(f"[kernels] {name} {dname} B,M,N,A,F={b},{m},{n},{a},{f}: "
                f"max_abs_err {max_err:.3e} max |err|/(1+|plain|) "
                f"{rel_err:.3e} mean_abs_err {mean_err:.3e} (tol "
                f"{tol_max:g}/{tol_mean:g}); kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, bound {row['bound_ms']:.4f} ms "
                f"({row['bound_by']}); library_ms null: no single PyTorch "
                f"call computes this function")
            if not (rel_err <= tol_max and mean_err <= tol_mean):
                fail(f"{name} {dname} disagrees with its plain version")
            del args, out, ref
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    return results


# ------------------------------------------------------------ phase 3 ----

def compare(a, b):
    d = abs(a.astype("float64") - b.astype("float64"))
    return float(d.max()), float(d.mean())


def profile_forward(torch, engine, batch):
    """Device time by kernel over one served batch-8 forward
    (torch.profiler, CUPTI): only device-side events (kernels and copies)
    are summed, so operator rows do not count their kernels twice; the busy
    share is that sum over the forward's host wall time under the
    profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.forward(batch)
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    if busy <= 0:
        log("[profile] the profiler saw no device time")
        return {}
    groups = {"epilogue kernels": "epilogue_kernel", "copies": "Memcpy"}
    split = {g: sum(r[0] for r in rows if k in r[2]) for g, k in groups.items()}
    log(f"[profile] one batch-8 forward: wall {wall_ms:.3f} ms under the "
        f"profiler, device busy {busy:.3f} ms ({100 * busy / wall_ms:.1f}%); "
        + ", ".join(f"{g} {v:.3f} ms" for g, v in split.items()))
    for ms, count, key in rows[:15]:
        log(f"[profile]   {ms:9.3f} ms  x{count:<4d} {key[:110]}")
    return dict(profile_wall_ms=wall_ms, profile_device_busy_ms=busy,
                profile_epilogue_ms=split["epilogue kernels"],
                profile_copy_ms=split["copies"])


def serve(torch, np, epi, ckdir, logger):
    from segtran_tpu_torch.cli.serve import (InferenceEngine, build_argparser,
                                             build_model_and_config,
                                             task_settings)
    from segtran_tpu_torch.models.segtran2d import init_segtran2d
    from segtran_tpu_torch.train.checkpoint import save_checkpoint

    argv = SERVE_ARGV + ["--fusedepi", "--cpdir", ckdir, "--iter", "1"]
    args = build_argparser().parse_args(argv)
    model, cfg = build_model_and_config(args, task_settings(args))
    if cfg.translayer_dims != (1792, 1792, 896, 448):
        fail(f"unexpected translayer dims {cfg.translayer_dims}")
    save_checkpoint(ckdir, 1, init_segtran2d(model, seed=0).state_dict(), cfg)
    del model
    engine = InferenceEngine(args, logger)
    rng = np.random.RandomState(0)
    images = [rng.rand(576, 576, 3).astype(np.float32) for _ in range(16)]
    try:
        engine.forward(np.zeros((8, 576, 576, 3), np.float32))   # warm
        answers = {}

        def client(c):
            # like an HTTP handler: read the answer, then let it go (the
            # page-locked block it views is reused by a later batch)
            for j in range(4):
                p = engine.submit(images[4 * c + j])
                p.event.wait()
                answers[4 * c + j] = (
                    p.error, None if p.error else p.probs.shape,
                    p.error is None and bool(np.isfinite(p.probs).all()))

        epi.reset_launches()
        before = engine.stats()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in (
            epi.fused_mid_output_pool_permode, epi.fused_mid_output_pool,
            epi.fused_private_output_pool)}
        st = engine.stats()
        batches = st["batches"] - before["batches"]
        for i, (error, shape, finite) in answers.items():
            if error is not None:
                fail(f"request {i} failed: {error!r}")
            if shape != (576, 576, 3) or not finite:
                fail(f"request {i}: bad answer {shape}, finite {finite}")
        if len(answers) != 16:
            fail(f"{len(answers)} of 16 requests answered")
        log(f"[serving] launches in the served run: {json.dumps(launches)} "
            f"over {batches} forwards")
        if (launches["fused_mid_output_pool_permode"] != 4 * batches
                or launches["fused_mid_output_pool"] != 2 * batches
                or launches["fused_private_output_pool"] != 0):
            fail("the served forwards did not run 4 per-mode + 2 all-modes "
                 "epilogue launches each")

        batch = np.stack(images[:8])
        fwd_ms = []
        for _ in range(3):
            t1 = time.perf_counter()
            fused = engine.forward(batch)
            fwd_ms.append((time.perf_counter() - t1) * 1e3)
        perf = dict(requests=16, seconds=wall, requests_per_s=16 / wall,
                    forwards=batches,
                    avg_batch_occupancy=st["avg_batch_occupancy"],
                    latency_ms_p50=st["latency_ms_p50"],
                    latency_ms_p95=st["latency_ms_p95"],
                    batch_ms_p50_served=st["batch_ms_p50"],
                    forward_ms_batch8=sorted(fwd_ms)[1])
        perf.update(profile_forward(torch, engine, batch))
    finally:
        engine.close()
    state = engine.model.state_dict()
    cfg = engine.cfg
    del engine
    torch.cuda.empty_cache()

    unfused_args = build_argparser().parse_args(
        SERVE_ARGV + ["--cpdir", ckdir, "--iter", "1"])
    ref_engine = InferenceEngine(unfused_args, logger)
    try:
        ref = ref_engine.forward(batch)
    finally:
        ref_engine.close()
    del ref_engine
    mx, mean = compare(fused, ref)
    perf.update(fused_vs_unfused_max_abs=mx, fused_vs_unfused_mean_abs=mean)
    log(f"[serving] fused vs unfused probabilities (bf16): max {mx:.3e} "
        f"mean {mean:.3e} (tol {MODEL_TOL[0]:g}/{MODEL_TOL[1]:g})")
    if not (mx <= MODEL_TOL[0] and mean <= MODEL_TOL[1]):
        fail("fused serving forward disagrees with the unfused modules")
    return perf, launches, state, cfg, batch


# ------------------------------------------------------------ phase 4 ----

def nonreassociated(torch, np, epi, state, cfg, batch):
    from segtran_tpu_torch.infer.sliding import sliding_window_2d
    from segtran_tpu_torch.models.segtran2d import Segtran2d
    from segtran_tpu_torch.data.stats import load_dataset_stats

    mean, std = load_dataset_stats("fundus", 0.5, "train")
    dev = torch.device("cuda")
    mean_t = torch.tensor(mean, device=dev)
    std_t = torch.tensor(std, device=dev)
    gray_w = torch.tensor([0.299, 0.587, 0.114], device=dev)

    def run(model, x):
        def fn(im):
            gray = torch.tensordot(im, gray_w, dims=([-1], [0]))[..., None]
            return model((0.5 * im + 0.5 * gray - mean_t) / std_t)
        with torch.inference_mode():
            return sliding_window_2d(fn, x, (576, 576), (288, 288),
                                     num_classes=3).cpu().numpy()

    x = torch.from_numpy(batch[:2]).to(dev)
    outs = {}
    for fusedepi in (True, False):
        c = dataclasses.replace(cfg, reassociate=False,
                                use_fused_epilogue=fusedepi)
        model = Segtran2d(c)
        model.load_state_dict(state, strict=True)
        model = model.to(dev).eval()
        run(model, x)                                      # warm
        epi.reset_launches()
        outs[fusedepi] = run(model, x)
        if fusedepi:
            launches = epi.fused_private_output_pool.launches
            others = (epi.fused_mid_output_pool.launches
                      + epi.fused_mid_output_pool_permode.launches)
        del model
        torch.cuda.empty_cache()
    log(f"[nonreassoc] fused_private_output_pool launches: {launches}")
    if launches != 3 or others != 0:
        fail("the non-reassociated forward did not run the private-output "
             "kernel once per translayer")
    if not np.isfinite(outs[True]).all():
        fail("non-reassociated forward is not finite")
    mx, mean = compare(outs[True], outs[False])
    log(f"[nonreassoc] fused vs unfused probabilities (bf16): max {mx:.3e} "
        f"mean {mean:.3e} (tol {MODEL_TOL[0]:g}/{MODEL_TOL[1]:g})")
    if not (mx <= MODEL_TOL[0] and mean <= MODEL_TOL[1]):
        fail("non-reassociated fused forward disagrees with the unfused one")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU is available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "segtran_tpu_torch", "csrc")):
        print("chip_smoke: the port's sources are not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np
    from segtran_tpu_torch.kernels import _build
    from segtran_tpu_torch.kernels import expansion_epilogue as epi

    t_all = time.perf_counter()
    card = card_line(torch)
    log(f"[build] card: {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    t0 = time.perf_counter()
    _build.build(_build.all_sources())
    log(f"[build] {len(_build.all_sources())} source(s) in "
        f"{time.perf_counter() - t0:.1f} s")
    for src, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {src}: {line.strip()}")

    kernels = check_kernels(torch, epi)
    logger = logging.getLogger("chip_smoke")
    logger.addHandler(logging.StreamHandler(sys.stderr))
    logger.setLevel(logging.INFO)
    ckdir = os.path.join(ROOT, "build", "chip_smoke")
    try:
        perf, launches, state, cfg, batch = serve(torch, np, epi, ckdir,
                                                  logger)
        log(f"[serving] {json.dumps(perf)} on {card}")
        launches["fused_private_output_pool"] = nonreassociated(
            torch, np, epi, state, cfg, batch)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)

    replaces = {
        "fused_mid_output_pool": "segtran_tpu/kernels/expansion_epilogue.py:333",
        "fused_mid_output_pool_permode":
            "segtran_tpu/kernels/expansion_epilogue.py:226",
        "fused_private_output_pool":
            "segtran_tpu/kernels/expansion_epilogue.py:289"}
    # one entry per kernel: bf16 (the serving dtype) at the first shape of
    # each; every measured row is printed above
    entries = []
    for name in ("fused_mid_output_pool_permode", "fused_mid_output_pool",
                 "fused_private_output_pool"):
        r = next(k for k in kernels if k["name"] == name and k["dtype"] == "bf16")
        entries.append(dict(
            name=name, route="cuda",
            source="segtran_tpu_torch/csrc/expansion_epilogue.cu",
            replaces=replaces[name], launches=launches[name],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None))
    log(f"[done] {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": entries, "card": card}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
