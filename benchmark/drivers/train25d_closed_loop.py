"""Closed-loop training of Segtran 2.5D through ``cli/train3d.py``, as
``train_closed_loop`` runs the I3D recipe: ``build_model_and_config``
with ``--segtran 25d``, ``make_step`` (the augmentation, the forward, the
loss, the backward, the global clip and BertAdam) wrapped by
``parallel/mesh.TrainMesh``, fed by ``data/pipeline.batch_iterator`` and
``DevicePrefetcher`` from an in-memory ``BratsSet`` of seeded volumes,
one metrics read-back per step.

    python3 -m benchmark.run --workload brats25d-train --seed <n> \\
        --seconds 50 --trace 0|1

Set-up builds the model and optimizer once from the seeded weights and
drives them through three checked steps and the warm steps; the window
then steps until ``--seconds`` have passed. The augmentation's draws come
from the benchmark's seed, and the EfficientNet's drop-connect from the
program's own generator (seeded with the run's data seed); the reference
replays both. Afterwards the program is freed and the plain reference
(``reference/segtran25d.py`` through ``reference/steps.Trainer``, float32,
TF32 off) replays the three steps from the same weights, volumes, crops
and draws; the readings are ``train_closed_loop``'s: step 1's logits,
each step's loss, each leaf's first gradient and its change after three
steps. A traced run counts the flash forward and backward launches of its
slice (``traced_launches``) and reads the slices the backbone took per
step from the program's counter ``segtran25d.slices``.
"""
from __future__ import annotations

import time

import torch

from benchmark import harness as H
from benchmark import inputs
from benchmark.drivers import train_closed_loop as base
from benchmark.reference import nets
from benchmark.reference import segtran25d as r25
from benchmark.reference import steps
from benchmark.reference import train3d as ref

CHECKED_STEPS = base.CHECKED_STEPS


def launches():
    """{kernel: launches so far} of the flash forward and backward."""
    from segtran_tpu_torch.kernels import squeezed_attention as sa
    return {"flash_fwd": sa.fused_cross_attention.launches,
            "flash_bwd": sa.flash_backward_dkdv.launches}


def slices():
    """The program's count of slices through the 2.5D backbone, or None
    where the program keeps no such counter."""
    from segtran_tpu_torch.utils import tracing
    if not hasattr(tracing, "counters"):
        return None
    return tracing.counters().get("segtran25d.slices", 0)


def run(ctx) -> H.Outcome:
    tr, t, dev = ctx.workload["traffic"], ctx.config["train"], ctx.device
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    model, par, step, args, task, state = base.build(ctx)
    opt = par.optimizer
    names = [n for n, _ in model.named_parameters()]
    p0 = {n: state[n].clone() for n in names}
    state = {k: v.cpu() for k, v in state.items()}
    size = tuple(tr.get("volume_size", ctx.config["model"]["volume_size"]))
    vols = [inputs.volume(size, ctx.seed * 16 + j, dev)
            for j in range(tr["volumes"])]
    crop = tuple(tr.get("crop_size", t["crop_size"]))
    feed = base.Feed(base.memory_dataset(vols, crop, args.seed), args, par,
                     dev)
    gen = torch.Generator().manual_seed(H.torch_seed(ctx.seed, 6))
    bs = args.batch_size
    if "state_unchanged" in ctx.faults:
        opt.step = lambda *a, **k: None
    if "half_batch" in ctx.faults:
        full = step

        def step(batch, draws=None):                      # noqa: F811
            return full({k: v[:bs // 2] for k, v in batch.items()}, draws)

    draws, losses = [], []
    first_grad, change = {}, {}

    def one_step():
        batch = feed.next()
        d = base.draw(gen, bs, args.randscale)
        metrics = step(batch, d)
        values = torch.stack(list(metrics.values())).tolist()
        return d, dict(zip(metrics, values))

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
            if i == 0:
                with torch.no_grad():
                    norms = torch.stack([
                        opt.state[p]["m"].norm() / (1 - base.B1)
                        if p in opt.state else torch.zeros((), device=p.device)
                        for p in model.parameters()]).tolist()
                first_grad = dict(zip(names, norms))
            if i == CHECKED_STEPS - 1:
                with torch.no_grad():
                    norms = torch.stack([(p.detach() - p0[n]).norm()
                                         for n, p in model.named_parameters()
                                         ]).tolist()
                change = dict(zip(names, norms))
                del p0
        sync()
        # a traced run profiles the steps of the window's last trace_s
        # seconds and reads its host-side metrics from the steps before
        t_slice = ctx.seconds - tr["trace_s"] if ctx.trace else float("inf")
        steps_done, traced = 0, {}
        slices0 = slices()
        t0, t0_ns = time.perf_counter(), time.time_ns()
        setup_s = ctx.setup_done()
        while True:
            el = time.perf_counter() - t0
            if el >= ctx.seconds:
                break
            if not traced and el >= t_slice:
                traced.update(n0=launches(), steps=steps_done, el=el,
                              t_ns=time.time_ns())
                ctx.tracer.start()
            one_step()
            steps_done += 1
        sync()
        window = time.perf_counter() - t0
        if traced:
            traced["n1"] = launches()
            ctx.tracer.stop()
        slices1 = slices()
    finally:
        feed.close()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    del model, par, step, opt, feed
    if cuda:
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    readings = reference_readings(ctx, state, vols, crop, args.seed, draws,
                                  losses, first_grad, change, logits[0],
                                  nets.FP32)
    checks = [H.Check(name, readings.get(name, float("nan")), limit)
              for name, limit in ctx.workload["checks"].items()]
    counters = {"readings": readings, "steps": steps_done,
                "traced_items": steps_done - traced["steps"] if traced else 0,
                "mfu_items": traced.get("steps", steps_done),
                "mfu_seconds": traced.get("el", window),
                "window_t0_ns": t0_ns,
                "window_t1_ns": traced.get("t_ns", time.time_ns()),
                "state_shapes": {k: tuple(v.shape) for k, v in state.items()}}
    if slices0 is not None and steps_done:
        counters["slices_per_step"] = (slices1 - slices0) / steps_done
    if "n1" in traced:
        counters["traced_launches"] = {k: traced["n1"][k] - traced["n0"][k]
                                       for k in traced["n0"]}
    e2e = {"train_step_ms": window / max(steps_done, 1) * 1e3,
           "setup_s": setup_s}
    ctx.log(f"train25d: {steps_done} steps in {window:.3f} s, "
            f"{e2e['train_step_ms']:.3f} ms per step; slices per step "
            f"{counters.get('slices_per_step')}; traced launches "
            f"{counters.get('traced_launches')}; losses {losses}")
    return H.Outcome(attempted=steps_done, failed=0, end_to_end=e2e,
                     checks=checks, memory_peak_bytes=peak, window_s=window,
                     counters=counters)


def trainer(ctx, params, buffers, data_seed, prec):
    """The reference step of the cell's configuration, its drop-connect
    drawn from a generator seeded as the program's."""
    t, dev = ctx.config["train"], ctx.device
    hp = dict(t, input_size=tuple(ctx.workload["traffic"].get(
        "input_size", t["input_size"])))
    gen = torch.Generator(device=dev).manual_seed(data_seed)
    return steps.Trainer(params, buffers, ctx.config["model"], hp,
                         r25.forward(gen, chunked=True), prec)


def replay(trainer, vols, crop, data_seed, draws, dev):
    """The reference's losses over the first batches of the feed."""
    bs = len(draws[0]["rot_flip"][0])
    return [trainer.step(torch.from_numpy(b["image"]).to(dev),
                         torch.from_numpy(b["label"]).to(dev), d)
            for b, d in zip(ref.batches(vols, bs, data_seed, crop,
                                        len(draws)), draws)]


def norms(trainer, state):
    with torch.no_grad():
        grad = dict(zip(trainer.first_grads, torch.stack(
            [g.norm() for g in trainer.first_grads.values()]).tolist()))
        moved = dict(zip(trainer.params, torch.stack(
            [(trainer.params[k] - state[k].to(v.device)).norm()
             for k, v in trainer.params.items()]).tolist()))
    return grad, moved


def split(state, names, dev):
    params = {k: state[k].to(dev) for k in names}
    return params, {k: v.to(dev) for k, v in state.items() if k not in params}


def control(ctx, prec):
    """Readings of the reference in ``prec`` put in the program's place:
    its three steps from the same weights, volumes, crops and draws."""
    from segtran_tpu_torch.cli import train3d
    tr, t, dev = ctx.workload["traffic"], ctx.config["train"], ctx.device
    args = train3d.build_argparser().parse_args(
        list(t["argv"]) + ["--device", dev.type] + tr.get("extra_argv", []))
    with torch.device("meta"):
        meta, _ = train3d.build_model_and_config(
            args, train3d.train_task_settings(args))
    state = inputs.seeded_state(inputs.model_shapes(meta), ctx.seed, dev)
    names = [n for n, _ in meta.named_parameters()]
    size = tuple(tr.get("volume_size", ctx.config["model"]["volume_size"]))
    vols = [inputs.volume(size, ctx.seed * 16 + j, dev)
            for j in range(tr["volumes"])]
    crop = tuple(tr.get("crop_size", t["crop_size"]))
    gen = torch.Generator().manual_seed(H.torch_seed(ctx.seed, 6))
    d = [base.draw(gen, args.batch_size, args.randscale)
         for _ in range(CHECKED_STEPS)]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    data_seed = ctx.seed % (2 ** 62)
    low = trainer(ctx, *split(state, names, dev), data_seed, prec)
    losses = replay(low, vols, crop, data_seed, d, dev)
    first, change = norms(low, state)
    first_logits = low.first_logits
    del low
    return reference_readings(ctx, state, vols, crop, data_seed, d, losses,
                              first, change, first_logits, nets.FP32)


def reference_readings(ctx, state, vols, crop, data_seed, draws, losses,
                       first_grad, change, first_logits, prec):
    """The reference's three steps and the readings of the program's
    against them (``train_closed_loop``'s numbers)."""
    dev = ctx.device
    trn = trainer(ctx, *split(state, first_grad, dev), data_seed, prec)
    ref_losses = replay(trn, vols, crop, data_seed, draws, dev)
    ref_grad, ref_change = norms(trn, state)
    ref_logits = trn.first_logits
    del trn
    readings = {"first_logit_gap": (
        float((first_logits - ref_logits).abs().sum() / ref_logits.abs().sum())
        if first_logits.shape == ref_logits.shape else float("inf")),
        "loss_gap": max(abs(a - b) / abs(b)
                        for a, b in zip(losses, ref_losses)),
        "first_loss_gap": abs(losses[0] - ref_losses[0]) / abs(ref_losses[0])}
    grad, left = base.leaf_gaps(first_grad, ref_grad, ref_grad)
    moved, _ = base.leaf_gaps(change, ref_change, ref_grad)
    r, grad_detail = base.summary(grad, first_grad, ref_grad, "first_grad")
    readings.update(r)
    r, change_detail = base.summary(moved, change, ref_change, "change")
    readings.update(r)
    ctx.log(f"reference losses {ref_losses}; program {losses}; {left} "
            f"leaves left out (reference first gradient under 1e-3 of the "
            f"median leaf's); worst gradient leaves (gap, program, "
            f"reference) {grad_detail}; worst change leaves {change_detail}")
    ctx.log(f"readings: {readings}")
    return readings
