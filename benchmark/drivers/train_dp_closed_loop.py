"""Closed-loop data-parallel training of the BraTS recipe over four cards,
one process per card: ``cli/train3d.py``'s step with ``--ndevices 4``
(``parallel/mesh.TrainMesh``: the global batch's BatchNorm statistics,
losses and draws, the gradients averaged over the ranks before the clip,
BertAdam on every rank alike), each rank fed its rows of every global
batch by ``data/pipeline.batch_iterator`` and ``DevicePrefetcher`` from
in-memory seeded volumes, one metrics read-back per step.

    python3 -m benchmark.run --workload brats-train-dp4 --seed <n> \\
        --seconds 50 --trace 0|1

The benchmark's process is rank 0. It spawns ranks 1-3 (this file run as
a script, ``--rank r --spec <json>``); every rank joins the group through
``parallel/multihost.init_multihost`` on ``tcp://localhost`` at a free
port, NCCL on the cards (gloo on the CPU), cuda:r its card. Set-up,
checked and warm steps run alike on every rank; in the window rank 0
decides before each step whether another starts and tells the others
over a gloo group. Rank 0's clock, spans and profiled slice give the
metrics: ``train_step_ms`` is one global step of 16; ``dp.allreduce_mb``
reads the program's counter ``dp.allreduce_bytes`` over the window's
steps; ``memory_peak_bytes`` is the fullest card's.

After the window the ranks compare their weights (``rank_weight_gap``,
the largest difference between two ranks' values of any weight), free
the program, and run the plain reference (``reference/train_dp.py``,
float32, TF32 off) on the same shards of the same batches and draws, with
the global batch's statistics; the readings are ``train_closed_loop``'s,
step 1's logits compared over the global batch.

Every rank is watched: a rank that exits with an error, or a run still
going ``DEADLINE_S`` past its window, ends every rank and rank 0 exits 1
with no result line; ranks 1-3 end themselves when rank 0 is gone.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import threading
import time

import torch
import torch.distributed as dist

if __package__ in (None, ""):                 # a rank run as a script
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

from benchmark import harness as H  # noqa: E402
from benchmark import inputs  # noqa: E402
from benchmark.drivers import train_closed_loop as base  # noqa: E402
from benchmark.reference import nets, train_dp  # noqa: E402
from benchmark.reference import train3d as ref  # noqa: E402

WORLD = 4
CHECKED_STEPS = base.CHECKED_STEPS
# set-up, the window's end and the reference, beyond --seconds
DEADLINE_S = 900.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def allreduce_bytes():
    """The program's count of bytes all-reduced so far, or None where the
    program keeps no such counter."""
    from segtran_tpu_torch.utils import tracing
    if not hasattr(tracing, "counters"):
        return None
    return tracing.counters().get("dp.allreduce_bytes", 0)


def run(ctx) -> H.Outcome:
    return launch(ctx, None)


def control(ctx, prec):
    """Readings of the reference in ``prec`` put in the program's place on
    the four ranks: its three steps from the same weights, volumes, crops
    and draws."""
    return launch(ctx, prec.name).counters["readings"]


def launch(ctx, control_prec):
    """Rank 0 here, ranks 1-3 spawned and watched."""
    spec = {"workload": ctx.workload, "config": ctx.config, "seed": ctx.seed,
            "seconds": ctx.seconds, "faults": list(ctx.faults),
            "control": control_prec, "port": free_port(),
            "device": ctx.device.type}
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(H.ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--rank", str(r), "--spec", json.dumps(spec)],
                              cwd=str(H.ROOT), env=env)
             for r in range(1, WORLD)]
    done = threading.Event()
    deadline = time.monotonic() + ctx.seconds + DEADLINE_S

    def end_all(why):
        ctx.log(f"train_dp: {why}; ending every rank")
        for p in procs:
            if p.poll() is None:
                p.kill()
        os._exit(1)

    def watch():
        while not done.wait(1.0):
            bad = [(r, p.returncode) for r, p in enumerate(procs, 1)
                   if p.poll() not in (None, 0)]
            if bad:
                end_all(f"rank(s) exited with errors {bad}")
            if time.monotonic() > deadline:
                end_all(f"still running {DEADLINE_S:.0f} s past the window")

    threading.Thread(target=watch, daemon=True).start()
    try:
        out = rank_main(ctx, 0, spec)
        for r, p in enumerate(procs, 1):
            rc = p.wait(timeout=max(deadline - time.monotonic(), 1.0))
            if rc != 0:
                raise RuntimeError(f"rank {r} exited with {rc}")
    except BaseException:
        for p in procs:
            if p.poll() is None:
                p.kill()
        raise
    finally:
        done.set()
    return out


def shard(draws, rows):
    """This rank's rows of one global step's draws."""
    return {"rot_flip": tuple(v[rows] for v in draws["rot_flip"]),
            "zoom": draws["zoom"]}


def rank_main(ctx, rank, spec):
    from segtran_tpu_torch.ops.norm import shard_rows
    from segtran_tpu_torch.parallel.multihost import init_multihost
    os.environ.update(WORLD_SIZE=str(WORLD), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    init_multihost(ctx.device, init_method=f"tcp://localhost:{spec['port']}")
    ctrl = dist.new_group(backend="gloo")
    out = steps_and_checks(ctx, rank, spec, ctrl, shard_rows)
    dist.barrier(group=ctrl)
    dist.destroy_process_group()
    return out


def steps_and_checks(ctx, rank, spec, ctrl, shard_rows):
    tr, t, dev = ctx.workload["traffic"], ctx.config["train"], ctx.device
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    size = tuple(tr.get("volume_size", ctx.config["model"]["volume_size"]))
    vols = [inputs.volume(size, ctx.seed * 16 + j, dev)
            for j in range(tr["volumes"])]
    crop = tuple(tr.get("crop_size", t["crop_size"]))
    gen = torch.Generator().manual_seed(H.torch_seed(ctx.seed, 6))
    data_seed = ctx.seed % (2 ** 62)
    if spec["control"]:
        args = train_args(ctx, data_seed)
        rows = shard_rows(args.batch_size, rank, WORLD)
        draws = [base.draw(gen, args.batch_size, args.randscale)
                 for _ in range(CHECKED_STEPS)]
        state, names = seeded_state(ctx, args, dev)
        losses, first_grad, change, first_logits = reference(
            ctx, state, names, vols, crop, data_seed, draws, rows,
            nets.Prec(spec["control"]))
        readings = reference_readings(ctx, rank, state, names, vols, crop,
                                      data_seed, draws, rows, losses,
                                      first_grad, change, first_logits, 0.0)
        return H.Outcome(0, 0, {}, [], 0, 0.0, {"readings": readings})

    model, par, step, args, task, state = base.build(ctx)
    opt = par.optimizer
    names = [n for n, _ in model.named_parameters()]
    p0 = {n: state[n].clone() for n in names}
    state = {k: v.cpu() for k, v in state.items()}
    rows = shard_rows(args.batch_size, rank, WORLD)
    feed = base.Feed(base.memory_dataset(vols, crop, args.seed), args, par,
                     dev)
    if "state_unchanged" in ctx.faults:
        opt.step = lambda *a, **k: None
    if "half_batch" in ctx.faults:
        full = step

        def step(batch, draws=None):                      # noqa: F811
            half = len(rows) // 2
            return full({k: v[:half] for k, v in batch.items()},
                        shard(draws, slice(0, half)))

    draws, losses = [], []
    first_grad, change = {}, {}

    def one_step():
        batch = feed.next()
        d = base.draw(gen, args.batch_size, args.randscale)
        metrics = step(batch, shard(d, rows))
        values = torch.stack(list(metrics.values())).tolist()
        return d, dict(zip(metrics, values))

    def go(flag: bool) -> bool:
        """Rank 0's decision, on every rank."""
        box = torch.tensor([int(flag)])
        dist.broadcast(box, 0, group=ctrl)
        return bool(box.item())

    logits = []
    hook = model.register_forward_hook(
        lambda m, i, out: logits.append(out.detach().float().cpu()))
    try:
        for i in range(CHECKED_STEPS + tr["warm_steps"]):
            d, values = one_step()
            hook.remove()                      # step 1's forward only
            if i < CHECKED_STEPS:
                draws.append(d)
                losses.append(values["loss"])
            if i == 0 and rank == 0:
                with torch.no_grad():
                    norms = torch.stack([
                        opt.state[p]["m"].norm() / (1 - base.B1)
                        if p in opt.state else torch.zeros((), device=p.device)
                        for p in model.parameters()]).tolist()
                first_grad = dict(zip(names, norms))
            if i == CHECKED_STEPS - 1:
                if rank == 0:
                    with torch.no_grad():
                        norms = torch.stack([
                            (p.detach() - p0[n]).norm()
                            for n, p in model.named_parameters()]).tolist()
                    change = dict(zip(names, norms))
                del p0
        sync()
        t_slice = ctx.seconds - tr["trace_s"] if ctx.trace else float("inf")
        steps_done, traced = 0, {}
        bytes0 = allreduce_bytes()
        t0, t0_ns = time.perf_counter(), time.time_ns()
        setup_s = ctx.setup_done()
        while True:
            el = time.perf_counter() - t0
            if not go(el < ctx.seconds):
                break
            if rank == 0 and not traced and el >= t_slice:
                traced.update(steps=steps_done, el=el, t_ns=time.time_ns(),
                              bytes=allreduce_bytes())
                ctx.tracer.start()
            one_step()
            steps_done += 1
        sync()
        window = time.perf_counter() - t0
        if traced:
            ctx.tracer.stop()
        gap = weight_gap(model)
    finally:
        feed.close()
    peak = torch.tensor([float(torch.cuda.max_memory_allocated()
                               if cuda else 0)], device=dev)
    dist.all_reduce(peak, op=dist.ReduceOp.MAX)
    del model, par, step, opt, feed
    if cuda:
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    readings = reference_readings(ctx, rank, state, names, vols, crop,
                                  args.seed, draws, rows, losses, first_grad,
                                  change, logits[0], gap)
    if rank:
        return None
    checks = [H.Check(name, readings.get(name, float("nan")), limit)
              for name, limit in ctx.workload["checks"].items()]
    counters = {"readings": readings, "steps": steps_done,
                "traced_items": steps_done - traced["steps"] if traced else 0,
                "mfu_items": traced.get("steps", steps_done),
                "mfu_seconds": traced.get("el", window),
                "window_t0_ns": t0_ns,
                "window_t1_ns": traced.get("t_ns", time.time_ns()),
                "state_shapes": {k: tuple(v.shape) for k, v in state.items()}}
    bytes1 = traced.get("bytes", allreduce_bytes())
    if bytes0 is not None and counters["mfu_items"]:
        counters["allreduce_bytes_per_step"] = (
            (bytes1 - bytes0) / counters["mfu_items"])
    e2e = {"train_step_ms": window / max(steps_done, 1) * 1e3,
           "setup_s": setup_s}
    ctx.log(f"train_dp: {steps_done} global steps in {window:.3f} s, "
            f"{e2e['train_step_ms']:.3f} ms per step; all-reduced "
            f"{counters.get('allreduce_bytes_per_step')} bytes per step; "
            f"losses {losses}")
    return H.Outcome(attempted=steps_done, failed=0, end_to_end=e2e,
                     checks=checks, memory_peak_bytes=int(peak.item()),
                     window_s=window, counters=counters)


@torch.no_grad()
def weight_gap(model) -> float:
    """The largest difference between two ranks' values of any weight or
    running statistic."""
    flat = torch.cat([t.detach().float().reshape(-1) for t in
                      list(model.parameters()) + list(model.buffers())
                      if t.is_floating_point()])
    hi, lo = flat.clone(), flat.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    return float((hi - lo).max())


def train_args(ctx, data_seed):
    from segtran_tpu_torch.cli import train3d
    t = ctx.config["train"]
    argv = list(t["argv"]) + ["--device", ctx.device.type, "--seed",
                              str(data_seed), "--maxiter", str(t["maxiter"])]
    return train3d.build_argparser().parse_args(
        argv + ctx.workload["traffic"].get("extra_argv", []))


def seeded_state(ctx, args, dev):
    """(the seeded weights, the names of the trainable leaves)."""
    from segtran_tpu_torch.cli import train3d
    with torch.device("meta"):
        meta, _ = train3d.build_model_and_config(
            args, train3d.train_task_settings(args))
    return (inputs.seeded_state(inputs.model_shapes(meta), ctx.seed, dev),
            [n for n, _ in meta.named_parameters()])


def reference(ctx, state, names, vols, crop, data_seed, draws, rows, prec):
    """This rank's share of the reference's three steps in ``prec``:
    (losses, first gradients, changes, step 1's logits); the losses, the
    first gradients and the changes are the group's, on every rank."""
    dev, t = ctx.device, ctx.config["train"]
    hp = dict(t, input_size=tuple(ctx.workload["traffic"].get(
        "input_size", t["input_size"])))
    params = {k: state[k].to(dev) for k in names}
    buffers = {k: v.to(dev) for k, v in state.items() if k not in params}
    trn = train_dp.Trainer(params, buffers, ctx.config["model"], hp, prec)
    bs = len(draws[0]["rot_flip"][0])
    losses = []
    for b, d in zip(ref.batches(vols, bs, data_seed, crop, len(draws)),
                    draws):
        losses.append(trn.step(torch.from_numpy(b["image"][rows]).to(dev),
                               torch.from_numpy(b["label"][rows]).to(dev),
                               shard(d, rows)))
    with torch.no_grad():
        grad = dict(zip(trn.first_grads, torch.stack(
            [g.norm() for g in trn.first_grads.values()]).tolist()))
        moved = dict(zip(trn.params, torch.stack(
            [(trn.params[k] - params[k]).norm()
             for k in trn.params]).tolist()))
    return losses, grad, moved, trn.first_logits


def reference_readings(ctx, rank, state, names, vols, crop, data_seed, draws,
                       rows, losses, first_grad, change, first_logits, gap):
    """The fp32 reference's three steps on every rank, and on rank 0 the
    readings of the program's (or the control's) against them."""
    ref_losses, ref_grad, ref_change, ref_logits = reference(
        ctx, state, names, vols, crop, data_seed, draws, rows, nets.FP32)
    sums = torch.tensor([float((first_logits - ref_logits).abs().sum())
                         if first_logits.shape == ref_logits.shape
                         else float("inf"),
                         float(ref_logits.abs().sum())], dtype=torch.float64,
                        device=ctx.device)
    dist.all_reduce(sums)
    if rank:
        return None
    readings = {"first_logit_gap": float(sums[0] / sums[1]),
                "loss_gap": max(abs(a - b) / abs(b)
                                for a, b in zip(losses, ref_losses)),
                "first_loss_gap": abs(losses[0] - ref_losses[0])
                / abs(ref_losses[0]),
                "rank_weight_gap": gap}
    grad, left = base.leaf_gaps(first_grad, ref_grad, ref_grad)
    moved, _ = base.leaf_gaps(change, ref_change, ref_grad)
    r, grad_detail = base.summary(grad, first_grad, ref_grad, "first_grad")
    readings.update(r)
    r, change_detail = base.summary(moved, change, ref_change, "change")
    readings.update(r)
    ctx.log(f"reference losses {ref_losses}; program {losses}; {left} "
            f"leaves left out; worst gradient leaves (gap, program, "
            f"reference) {grad_detail}; worst change leaves {change_detail}")
    ctx.log(f"readings: {readings}")
    return readings


def main(argv=None) -> int:
    """A rank other than 0: ``--rank r --spec <json>`` from rank 0."""
    p = argparse.ArgumentParser(description="a rank of the data-parallel "
                                            "train cell (spawned by rank 0)")
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--spec", required=True)
    a = p.parse_args(argv)
    spec = json.loads(a.spec)
    H.set_cache_dirs()
    parent = os.getppid()

    def orphaned():
        while os.getppid() == parent:
            time.sleep(1.0)
        os._exit(1)

    threading.Thread(target=orphaned, daemon=True).start()
    device = torch.device(spec["device"])
    ctx = H.Context(cell="", workload=spec["workload"], config=spec["config"],
                    seed=spec["seed"], seconds=spec["seconds"], trace=False,
                    t_process=time.time(), spans=H.Spans(False),
                    tracer=H.Tracer(False), device=device,
                    faults=tuple(spec["faults"]),
                    log=lambda m: print(m, file=sys.stderr, flush=True))
    rank_main(ctx, a.rank, spec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
