"""Closed-loop training through ``cli/train3d.py``: ``make_step`` (the
augmentation, the forward, the loss, the backward, the global clip and
BertAdam from ``train/trainer.build_optimizer``) wrapped by
``parallel/mesh.TrainMesh``, fed by ``data/pipeline.batch_iterator`` and
``DevicePrefetcher`` from an in-memory ``BratsSet`` of seeded volumes,
one metrics read-back per step: the loop of ``train3d.train()``.

Set-up builds the model and optimizer once from the seeded weights and
drives them through the first steps (three that the reference follows,
then the rest of the warm-up), through the same loop and feed as the
window; the window then steps until ``--seconds`` have passed. The
augmentation's draws (quarter turns, flips, zoom) come from the
benchmark's seed and go to both sides. Afterwards the program is freed
and the plain reference replays the first three steps in float32 (TF32
off) from the same weights, volumes, crops and draws: the logits of step
1's forward (the model's output inside the step), each step's loss, each
leaf's first gradient as BertAdam got it (read back from its first
moment after step 1) and each leaf's change after three steps.
"""
from __future__ import annotations

import statistics
import time

import torch

from benchmark import harness as H
from benchmark import inputs
from benchmark.reference import nets
from benchmark.reference import train3d as ref

CHECKED_STEPS = 3
B1 = 0.9                      # BertAdam's first-moment decay


def memory_dataset(vols, crop, seed):
    from segtran_tpu_torch.data.datasets3d import BratsSet

    class InMemoryBrats(BratsSet):
        """BratsSet's training crops over volumes held in memory."""

        def __init__(self):
            self.vols = vols
            self.case_list = [f"synthetic{i}" for i in range(len(vols))]
            self.mode, self.crop_size, self.seed, self.epoch = (
                "train", tuple(crop), seed, 0)
            self.binarize, self.remap_label4 = False, True

        def read(self, idx):
            return self.vols[idx]["image"], self.vols[idx]["label"]
    return InMemoryBrats()


class Feed:
    """train()'s feed: a batch_iterator per epoch behind a
    DevicePrefetcher, epoch after epoch."""

    def __init__(self, ds, args, par, device):
        from segtran_tpu_torch.data import pipeline
        self.pipeline, self.ds, self.args, self.par = pipeline, ds, args, par
        self.device, self.epoch, self.loader, self.it = device, 0, None, None

    def next(self):
        while True:
            if self.it is None:
                p = self.pipeline
                batches = p.batch_iterator(
                    self.ds, self.args.batch_size, self.epoch,
                    seed=self.args.seed, keys=("image", "label"),
                    shard=self.par.shard, microbatches=self.par.micro)
                self.loader = p.DevicePrefetcher(batches, self.device)
                self.it = iter(self.loader)
            try:
                return next(self.it)
            except StopIteration:
                self.close()
                self.epoch += 1

    def close(self):
        if self.loader is not None:
            self.loader.close()
        self.loader = self.it = None


def draw(gen, batch, randscale):
    """One step's augmentation draws."""
    k = torch.randint(0, 4, (batch,), generator=gen)
    flips = torch.rand((2, batch), generator=gen) < 0.5
    zoom = (1.0 - randscale) + 2.0 * randscale * float(
        torch.rand((), generator=gen))
    return {"rot_flip": (k, flips[0], flips[1]), "zoom": zoom}


def leaf_gaps(prog, refv, basis):
    """{leaf: |prog - ref| / max(ref, the median leaf's ref)} over the
    leaves whose reference first gradient (``basis``) is at least a
    thousandth of the median leaf's, and the count left out."""
    med_basis = statistics.median(basis.values())
    keep = [k for k in refv if basis[k] >= 1e-3 * med_basis]
    med = statistics.median(refv[k] for k in keep)
    return ({k: abs(prog[k] - refv[k]) / max(refv[k], med) for k in keep},
            len(refv) - len(keep))


def summary(gaps, prog, refv, label):
    """Readings of one per-leaf comparison: the worst leaf, the 90th
    percentile leaf and the median leaf; the five worst for the log."""
    vals = sorted(gaps.values())
    worst = sorted(gaps, key=gaps.get, reverse=True)[:5]
    detail = [(k, round(gaps[k], 5), prog[k], refv[k]) for k in worst]
    return ({f"{label}_gap": vals[-1],
             f"{label}_p90_gap": vals[int(0.9 * (len(vals) - 1))],
             f"{label}_median_gap": statistics.median(vals)}, detail)


def build(ctx):
    from segtran_tpu_torch.cli import train3d
    from segtran_tpu_torch.parallel.mesh import TrainMesh
    from segtran_tpu_torch.train.trainer import build_optimizer
    t, dev = ctx.config["train"], ctx.device
    data_seed = ctx.seed % (2 ** 62)
    argv = list(t["argv"]) + ["--device", dev.type, "--seed", str(data_seed),
                              "--maxiter", str(t["maxiter"])]
    argv += ctx.workload["traffic"].get("extra_argv", [])
    args = train3d.build_argparser().parse_args(argv)
    task = train3d.train_task_settings(args)
    with torch.device("meta"):
        meta, _ = train3d.build_model_and_config(args, task)
    state = inputs.seeded_state(inputs.model_shapes(meta), ctx.seed, dev)
    del meta
    model, cfg = train3d.build_model_and_config(args, task)
    model.load_state_dict(state, strict=True)
    model = model.to(dev)
    warm = min(args.lr_warmup_steps, args.maxiter // 2) / args.maxiter
    opt = build_optimizer(model, lr=args.lr, decay=args.decay,
                          t_total=args.maxiter, warmup_ratio=warm)
    par = TrainMesh(model, opt, args.ndevices, args.tensor_parallel,
                    grad_accum=args.grad_accum)
    step = par.wrap(train3d.make_step(model, par.optimizer, args, task, dev))
    return model, par, step, args, task, state


def run(ctx) -> H.Outcome:
    tr, t, dev = ctx.workload["traffic"], ctx.config["train"], ctx.device
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    model, par, step, args, task, state = build(ctx)
    opt = par.optimizer
    names = [n for n, _ in model.named_parameters()]
    p0 = {n: state[n].clone() for n in names}
    state = {k: v.cpu() for k, v in state.items()}
    size = tuple(tr.get("volume_size", ctx.config["model"]["volume_size"]))
    vols = [inputs.volume(size, ctx.seed * 16 + j, dev)
            for j in range(tr["volumes"])]
    crop = tuple(tr.get("crop_size", t["crop_size"]))
    feed = Feed(memory_dataset(vols, crop, args.seed), args, par, dev)
    gen = torch.Generator().manual_seed(H.torch_seed(ctx.seed, 6))
    bs = args.batch_size
    if "state_unchanged" in ctx.faults:
        opt.step = lambda *a, **k: None
    if "half_batch" in ctx.faults:
        full = step

        def step(batch, draws=None):                      # noqa: F811
            return full({k: v[:bs // 2] for k, v in batch.items()}, draws)
    if ctx.trace:
        opt.step = ctx.spans.wrap("train.optimizer", opt.step, sync)
        step = ctx.spans.wrap("train.step", step)

    draws, losses = [], []
    first_grad, change = {}, {}

    def one_step():
        t_wait = time.time_ns()
        batch = feed.next()
        ctx.spans.add("train.data_wait", t_wait, time.time_ns())
        d = draw(gen, bs, args.randscale)
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
                        opt.state[p]["m"].norm() / (1 - B1) if p in opt.state
                        else torch.zeros((), device=p.device)
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
        from segtran_tpu_torch.kernels import squeezed_attention as sa

        # a traced run profiles the steps of the window's last trace_s
        # seconds and reads its host-side metrics from the steps before
        t_slice = ctx.seconds - tr["trace_s"] if ctx.trace else float("inf")
        steps, traced = 0, {}
        t0, t0_ns = time.perf_counter(), time.time_ns()
        setup_s = ctx.setup_done()
        while True:
            el = time.perf_counter() - t0
            if el >= ctx.seconds:
                break
            if not traced and el >= t_slice:
                traced.update(n0=sa.fused_cross_attention.launches,
                              steps=steps, el=el, t_ns=time.time_ns())
                ctx.tracer.start()
            one_step()
            steps += 1
        sync()
        window = time.perf_counter() - t0
        if traced:
            traced["n1"] = sa.fused_cross_attention.launches
            ctx.tracer.stop()
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
    counters = {"readings": readings, "steps": steps,
                "traced_items": steps - traced["steps"] if traced else 0,
                "mfu_items": traced.get("steps", steps),
                "mfu_seconds": traced.get("el", window),
                "window_t0_ns": t0_ns,
                "window_t1_ns": traced.get("t_ns", time.time_ns()),
                "state_shapes": {k: tuple(v.shape) for k, v in state.items()}}
    if "n1" in traced:
        counters["traced_launches"] = {"flash_fwd": traced["n1"]
                                       - traced["n0"]}
    e2e = {"train_step_ms": window / max(steps, 1) * 1e3, "setup_s": setup_s}
    ctx.log(f"train: {steps} steps in {window:.3f} s, "
            f"{e2e['train_step_ms']:.3f} ms per step; losses {losses}")
    return H.Outcome(attempted=steps, failed=0, end_to_end=e2e,
                     checks=checks, memory_peak_bytes=peak, window_s=window,
                     counters=counters)


def control(ctx, prec):
    """Readings of the reference in ``prec`` put in the program's place:
    its three steps from the same weights, volumes, crops and draws."""
    from segtran_tpu_torch.cli import train3d
    tr, t, dev = ctx.workload["traffic"], ctx.config["train"], ctx.device
    argv = list(t["argv"]) + ["--device", dev.type]
    argv += tr.get("extra_argv", [])
    args = train3d.build_argparser().parse_args(argv)
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
    d = [draw(gen, args.batch_size, args.randscale)
         for _ in range(CHECKED_STEPS)]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    data_seed = ctx.seed % (2 ** 62)
    low = ref.Trainer({k: state[k] for k in names},
                      {k: v for k, v in state.items() if k not in names},
                      ctx.config["model"], dict(t, input_size=tuple(
                          tr.get("input_size", t["input_size"]))), prec)
    losses = []
    for b, dr in zip(ref.batches(vols, args.batch_size, data_seed, crop,
                                 CHECKED_STEPS), d):
        losses.append(low.step(torch.from_numpy(b["image"]).to(dev),
                               torch.from_numpy(b["label"]).to(dev), dr))
    with torch.no_grad():
        first = dict(zip(low.first_grads, torch.stack(
            [g.norm() for g in low.first_grads.values()]).tolist()))
        change = dict(zip(low.params, torch.stack(
            [(low.params[k] - state[k]).norm() for k in low.params]).tolist()))
    first_logits = low.first_logits
    del low
    return reference_readings(ctx, state, vols, crop, data_seed, d, losses,
                              first, change, first_logits, nets.FP32)


def reference_readings(ctx, state, vols, crop, data_seed, draws, losses,
                       first_grad, change, first_logits, prec):
    """The reference's three steps and the readings of the program's
    against them."""
    dev, t = ctx.device, ctx.config["train"]
    hp = dict(t, input_size=tuple(ctx.workload["traffic"].get(
        "input_size", t["input_size"])))
    params = {k: state[k].to(dev) for k in first_grad}
    buffers = {k: v.to(dev) for k, v in state.items() if k not in params}
    trainer = ref.Trainer(params, buffers, ctx.config["model"], hp, prec)
    bs = len(draws[0]["rot_flip"][0])
    ref_losses = []
    for b, d in zip(ref.batches(vols, bs, data_seed, crop, CHECKED_STEPS),
                    draws):
        ref_losses.append(trainer.step(
            torch.from_numpy(b["image"]).to(dev),
            torch.from_numpy(b["label"]).to(dev), d))
    with torch.no_grad():
        ref_grad = dict(zip(trainer.first_grads, torch.stack(
            [g.norm() for g in trainer.first_grads.values()]).tolist()))
        ref_change = dict(zip(trainer.params, torch.stack(
            [(trainer.params[k] - params[k]).norm()
             for k in trainer.params]).tolist()))
    ref_logits = trainer.first_logits
    readings = {"first_logit_gap": (
        float((first_logits - ref_logits).abs().sum() / ref_logits.abs().sum())
        if first_logits.shape == ref_logits.shape else float("inf")),
        "loss_gap": max(abs(a - b) / abs(b)
                                for a, b in zip(losses, ref_losses)),
                "first_loss_gap": abs(losses[0] - ref_losses[0])
                / abs(ref_losses[0])}
    grad, left = leaf_gaps(first_grad, ref_grad, ref_grad)
    moved, _ = leaf_gaps(change, ref_change, ref_grad)
    r, grad_detail = summary(grad, first_grad, ref_grad, "first_grad")
    readings.update(r)
    r, change_detail = summary(moved, change, ref_change, "change")
    readings.update(r)
    ctx.log(f"reference losses {ref_losses}; program {losses}; {left} "
            f"leaves left out (reference first gradient under 1e-3 of the "
            f"median leaf's); worst gradient leaves (gap, program, "
            f"reference) {grad_detail}; worst change leaves {change_detail}")
    ctx.log(f"readings: {readings}")
    return readings
