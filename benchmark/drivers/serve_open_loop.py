"""Open-loop serving through ``cli/serve.py``'s ``InferenceEngine``.

Set-up writes the seeded weights as a checkpoint under the temporary
directory and starts the engine from it, as a server starts; the engine
warms its one padded shape, and one more batch of real frames runs. The
window then submits frames from a seeded pool of ``pool`` frames at the
due times of an open-loop schedule (``inputs.arrivals``: the same gaps
for every seed, in the seed's order) to ``InferenceEngine.submit``, the
entry every HTTP handler calls, from this thread, while a collector
thread waits for the answers in order. A request's latency runs from
when it was due to when its answer was ready; one that fails or never
comes counts as missing. The frames answered by the window's close over
the window give the throughput of a cell offered more than the knee. After the window the engine is closed and freed,
and the plain reference recomputes the probabilities of a seeded sample
of the answered requests in float32 (TF32 off), in blocks of frames.
"""
from __future__ import annotations

import logging
import queue
import shutil
import tempfile
import threading
import time

import numpy as np
import torch

from benchmark import harness as H
from benchmark import inputs
from benchmark.reference import nets


def _engine_args(ctx, ckdir):
    from segtran_tpu_torch.cli import serve
    argv = list(ctx.config["serve_argv"]) + [
        "--cpdir", ckdir, "--iter", "1", "--device", ctx.device.type]
    args = serve.build_argparser().parse_args(argv)
    return serve, args, serve.task_settings(args)


def make_engine(ctx):
    """(the engine, started from a checkpoint of the seeded weights; those
    weights on the host, for the reference)."""
    from segtran_tpu_torch.train.checkpoint import save_checkpoint
    ckdir = tempfile.mkdtemp(prefix="bench-serve-")
    try:
        serve, args, task = _engine_args(ctx, ckdir)
        with torch.device("meta"):
            model, cfg = serve.build_model_and_config(args, task)
        state = inputs.seeded_state(inputs.model_shapes(model), ctx.seed,
                                    ctx.device)
        save_checkpoint(ckdir, 1, state, cfg)
        # the benchmark's copy waits on the host for the reference
        state = {k: v.cpu() for k, v in state.items()}
        del model
        engine = serve.InferenceEngine(
            args, logging.getLogger("benchmark.serve"))
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    return engine, state


def plant(engine, faults):
    """Faults a test plants underneath the timed path."""
    forward = engine.forward
    if "half_batch" in faults:
        def half(batch):
            h = batch.shape[0] // 2
            return forward(np.concatenate([batch[:h], batch[:h]]))
        engine.forward = half
    if "answer_altered" in faults:
        inner = engine.forward

        def altered(batch):
            out = inner(batch)
            out[0] = 1.0 - out[0]
            return out
        engine.forward = altered


def epilogue_launches(epi):
    """(per-mode launches, one per batch; all launches of the expansion
    epilogue's kernel, three per batch)."""
    permode = epi.fused_mid_output_pool_permode.launches
    return permode, permode + epi.fused_mid_output_pool.launches


def reference_probs(frames_np, state, cfg, prec, device, block):
    """The reference's probabilities of ``frames_np`` [n, S, S, 3]."""
    out = []
    for i in range(0, len(frames_np), block):
        x = torch.from_numpy(frames_np[i:i + block]).to(device)
        with torch.no_grad():
            out.append(nets.fundus_probs(x, state, cfg["model"], prec).cpu())
    return torch.cat(out).numpy()


def gaps(answers, ref):
    """Readings of answers [k, S, S, C] against the reference's: the
    worst answer's mean |gap| and its |gap| over the reference's p (1 - p)
    (near a logit gap: dp = p (1 - p) dlogit, so a seed's weights that
    saturate more of the map do not make it read smaller), the mean over
    answers, and the largest single gap."""
    r = ref.astype(np.float64)
    d = np.abs(answers.astype(np.float64) - r)
    per = d.reshape(len(d), -1).mean(1)
    sens = (d.reshape(len(d), -1).sum(1)
            / (r * (1 - r)).reshape(len(d), -1).sum(1).clip(min=1e-12))
    return {"worst_answer_mean_gap": float(per.max()),
            "worst_answer_sens_gap": float(sens.max()),
            "mean_gap": float(per.mean()), "max_gap": float(d.max())}


def schedule(ctx, n_pool):
    """(due times, frame of each request, the sampled requests)."""
    tr = ctx.workload["traffic"]
    due = inputs.arrivals(tr["rate_rps"], ctx.seconds, ctx.seed)
    rng = inputs.rng(ctx.seed, 4)
    frame_of = rng.integers(0, n_pool, len(due))
    sample = set(rng.choice(len(due), size=min(tr["check_answers"], len(due)),
                            replace=False).tolist())
    return due, frame_of, sample


def control(ctx, prec):
    """Readings of the reference in ``prec`` put in the program's place,
    on the frames a run of this seed would check."""
    tr, dev = ctx.workload["traffic"], ctx.device
    serve, args, task = _engine_args(ctx, "unused")
    with torch.device("meta"):
        model, _ = serve.build_model_and_config(args, task)
    state = inputs.seeded_state(inputs.model_shapes(model), ctx.seed, dev)
    size = tuple(task["orig_input_size"])
    pool = inputs.frames(tr["pool"], size[0], ctx.seed, dev).cpu().numpy()
    _, frame_of, sample = schedule(ctx, tr["pool"])
    frames_np = pool[frame_of[sorted(sample)]]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = reference_probs(frames_np, state, ctx.config, nets.FP32, dev,
                          tr["check_block"])
    low = reference_probs(frames_np, state, ctx.config, prec, dev,
                          tr["check_block"])
    return gaps(low, ref)


def run(ctx) -> H.Outcome:
    tr, dev = ctx.workload["traffic"], ctx.device
    engine, state = make_engine(ctx)
    plant(engine, ctx.faults)
    size = tuple(engine.orig)
    pool = inputs.frames(tr["pool"], size[0], ctx.seed, dev).cpu().numpy()
    engine.forward(pool[:engine.args.maxbatch])               # warm, real
    due, frame_of, sample = schedule(ctx, tr["pool"])
    n = len(due)
    if ctx.trace:
        engine.forward = ctx.spans.wrap("serve.forward", engine.forward)

    done = np.full(n, np.nan)
    errors = [None] * n
    kept = {}
    pending: "queue.Queue" = queue.Queue()
    deadline = [time.perf_counter() + 3600.0]

    def collect():
        for _ in range(n):
            i, p = pending.get()
            if not p.event.wait(max(0.0, deadline[0] - time.perf_counter())):
                errors[i] = "no answer"
                continue
            done[i] = time.perf_counter()
            if p.error is not None:
                errors[i] = repr(p.error)
            elif p.probs.shape != size + (engine.num_classes,):
                errors[i] = f"shape {p.probs.shape}"
            elif i in sample:
                kept[i] = np.array(p.probs)

    collector = threading.Thread(target=collect, daemon=True)
    collector.start()
    with engine._lock:
        c0 = dict(engine.counters)
    from segtran_tpu_torch.kernels import expansion_epilogue as epi

    # a traced run profiles the window's last trace_s seconds and reads
    # its host-side metrics from the part before them
    t_slice = ctx.seconds - tr["trace_s"] if ctx.trace else float("inf")
    t0 = time.perf_counter() + 0.01
    t0_ns = time.time_ns() + 10_000_000
    setup_s = ctx.setup_done()
    lag = np.zeros(n)
    traced, c_slice, n_before = {}, None, n
    for i in range(n):
        t_due = t0 + due[i]
        now = time.perf_counter()
        if now < t_due:
            time.sleep(t_due - now)
        if c_slice is None and due[i] >= t_slice:
            with engine._lock:
                c_slice = dict(engine.counters)
            n_before = i
            traced["t_ns"] = time.time_ns()
            traced["epi0"] = epilogue_launches(epi)
            ctx.tracer.start()
        ts = time.perf_counter()
        p = engine.submit(pool[frame_of[i]])
        lag[i] = ts - t_due
        pending.put((i, p))
    deadline[0] = t0 + ctx.seconds + 60.0
    collector.join(timeout=75.0)
    if c_slice is not None:
        traced["epi1"] = epilogue_launches(epi)
        ctx.tracer.stop()
    with engine._lock:
        c1 = dict(engine.counters)
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0

    for i in range(n):
        if errors[i] is None and np.isnan(done[i]):
            errors[i] = "no answer"
    failed = [i for i in range(n) if errors[i] is not None]
    lat = [float("inf") if errors[i] is not None else done[i] - (t0 + due[i])
           for i in range(n)]
    engine.close()
    del engine
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the reference, on the sampled answers that came
    idx = sorted(kept)
    checks, readings = [], {}
    if idx:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        state = {k: v.to(dev) for k, v in state.items()}
        ref = reference_probs(pool[frame_of[idx]], state, ctx.config,
                              nets.FP32, dev, tr["check_block"])
        readings = gaps(np.stack([kept[i] for i in idx]), ref)
    for name, limit in ctx.workload["checks"].items():
        checks.append(H.Check(name, readings.get(name, float("nan")), limit))
    ctx.log(f"readings: {readings} over {len(idx)} answers")
    third = max(n // 3, 1)
    ends = [done[i] for i in range(n) if errors[i] is None]
    c_host = c_slice or c1
    # the work done in the untraced part: frames answered by its end
    mfu_seconds = min(t_slice, ctx.seconds)
    answered_before = sum(1 for t in ends if t <= t0 + mfu_seconds)
    counters = {"requests": c_host["requests"] - c0["requests"],
                "completed_rps": (len(ends) / (max(ends) - t0)) if ends
                else 0.0,
                "p50_first_third_ms": H.percentile(lat[:third], 50) * 1e3,
                "p50_last_third_ms": H.percentile(lat[-third:], 50) * 1e3,
                "batches": c_host["batches"] - c0["batches"],
                "gen_lag_s": lag[:n_before].tolist(),
                "answered": n - len(failed),
                "mfu_items": answered_before,
                "mfu_seconds": mfu_seconds,
                "traced_items": (traced["epi1"][0] - traced["epi0"][0]
                                 if "epi1" in traced else 0),
                "readings": readings, "window_t0_ns": t0_ns,
                "window_t1_ns": traced.get("t_ns", t0_ns + int(
                    ctx.seconds * 1e9)), "state_shapes": {
                    k: tuple(v.shape) for k, v in state.items()}}
    # frames answered by the window's close, over the window: above the
    # knee the engine's throughput, whatever the backlog
    by_close = sum(1 for t in ends if t <= t0 + ctx.seconds)
    if "epi1" in traced:
        counters["traced_launches"] = {
            "epilogue": traced["epi1"][1] - traced["epi0"][1]}
    e2e = {"frames_per_s": by_close / ctx.seconds,
           "serve_p95_ms": H.percentile(lat, 95) * 1e3, "setup_s": setup_s}
    ctx.log(f"serve: {n} requests at {tr['rate_rps']} rps, "
            f"{e2e['frames_per_s']:.3f} frames/s answered by the close, p50 "
            f"{H.percentile(lat, 50) * 1e3:.2f} ms, p95 "
            f"{e2e['serve_p95_ms']:.2f} ms, p99 "
            f"{H.percentile(lat, 99) * 1e3:.2f} ms, occupancy "
            f"{counters['requests'] / max(counters['batches'], 1):.3f}")
    return H.Outcome(attempted=n, failed=len(failed), end_to_end=e2e,
                     checks=checks, memory_peak_bytes=peak,
                     window_s=ctx.seconds, counters=counters)
