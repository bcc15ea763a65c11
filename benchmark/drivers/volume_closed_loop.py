"""Closed-loop whole-volume evaluation through ``cli/test3d.py``'s
``evaluate_volume`` (one client: the next volume goes in when the last
one's probabilities, hard map and Dice are out).

Set-up builds the model with test3d's factory and the configuration's
evaluation flags, loads the seeded weights and evaluates each volume of a
seeded pool once (every shape the window meets). The window evaluates
pool volumes in a seeded order until ``--seconds`` have passed; the last
volume started inside it finishes and counts. Afterwards the model is
freed and the plain reference recomputes, in float32 (TF32 off), the
probabilities, hard maps and Dice of a seeded sample of the window's
answers from the same weights and volumes.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch
import torch.nn.functional as F

from benchmark import harness as H
from benchmark import inputs
from benchmark.reference import nets

# whole volumes are padded at the end to these multiples (H, W, D), as
# test3d's --wholevol does, and cropped back
MULTIPLES = (16, 16, 8)


def make_model(ctx):
    from segtran_tpu_torch.cli import test3d
    argv = list(ctx.config["eval_argv"]) + ["--cpdir", "unused", "--device",
                                            ctx.device.type]
    args = test3d.build_argparser().parse_args(argv)
    task = test3d.task_settings(args)
    with torch.device("meta"):
        meta, _ = test3d.build_model_and_config(args, task)
    state = inputs.seeded_state(inputs.model_shapes(meta), ctx.seed,
                                ctx.device)
    del meta
    model, _ = test3d.build_model_and_config(args, task)
    model.load_state_dict(state, strict=True)
    state = {k: v.cpu() for k, v in state.items()}
    return test3d, model.to(ctx.device).eval(), args, task, state


def plant(model_fn, faults):
    if "answer_altered" in faults:
        def altered(x):
            return -model_fn(x)
        return altered
    return model_fn


@contextlib.contextmanager
def planted_post(test3d, faults):
    """Faults a test plants in the post-processing, for the run: the
    regions' consistency fix skipped, the hard map's background inverted,
    or the Dice taken against the wrong regions' ground truth."""
    saved = (test3d.make_brats_pred_consistent, test3d.ground_truth,
             test3d.harden_segmap)
    if "consistency_skipped" in faults:
        test3d.make_brats_pred_consistent = lambda probs: probs
    if "background_inverted" in faults:
        def inverted(probs):
            hard = saved[2](probs)
            return torch.cat([1 - hard[..., :1], hard[..., 1:]], -1)
        test3d.harden_segmap = inverted
    if "dice_wrong_region" in faults:
        truth = saved[1]

        def rolled(*a, **k):
            gt = truth(*a, **k)
            return torch.cat([gt[..., :1], gt[..., 1:].roll(1, -1)], -1)
        test3d.ground_truth = rolled
    try:
        yield
    finally:
        (test3d.make_brats_pred_consistent, test3d.ground_truth,
         test3d.harden_segmap) = saved


def regions(label):
    """(background, ET, WT, TC) of labels {0, 1, 2, 3}, [..., 4]."""
    return np.stack([label == 0, label == 3, (label >= 1) & (label <= 3),
                     (label == 1) | (label == 3)], -1)


def sens_gap(probs, ref):
    """|gap| over the reference's p (1 - p), summed over the answer (near
    a logit gap, whatever share of the map a seed's weights saturate)."""
    return float((probs - ref).abs().sum() / (ref * (1 - ref)).sum()
                 .clamp(min=1e-12))


OFF = (0.01, 0.02, 0.05)
# a voxel is decided where every region's reference probability lies at
# least this far from the threshold 0.5
DECIDED = 0.02


def off_shares(probs, ref):
    """The shares of the answer's probabilities that lie more than each
    of OFF from the reference's."""
    d = (probs - ref).abs()
    return [float((d > t).float().mean()) for t in OFF]


def harden(probs):
    """The n-hot hard map of consistent probabilities [..., 4]: each
    region at 0.5, the background where no region fired."""
    hard = (probs >= 0.5).cpu().numpy()
    hard[..., 0] = ~hard[..., 1:].any(-1)
    return hard


def dice_of(hard, gt):
    """Dice of regions 1..3 of an n-hot hard map against n-hot regions."""
    return [(2 * float((hard[..., c] & gt[..., c]).sum()) + 1e-5)
            / (float(hard[..., c].sum() + gt[..., c].sum()) + 1e-5)
            for c in range(1, 4)]


def compare(answer, ref):
    """Readings of one answer (probabilities, hard map, Dice) against the
    reference's: the probabilities' gaps; the share of voxels whose hard
    map differs from the reference's hardening of the answer's own
    probabilities; the gap of each Dice from the Dice of the answer's own
    hard map against the reference's ground truth. Besides, for the log:
    the share of voxels whose hard map differs from the reference's hard
    map, where the reference has decided every region (each probability
    at least DECIDED from 0.5) and where it has not."""
    (probs, hard, dice), (rp, rh, rd, gt) = answer, ref
    probs = probs.float()
    hard = hard.astype(bool)
    differs = (hard != rh).any(-1)
    decided = ((rp[..., 1:] - 0.5).abs() >= DECIDED).all(-1).cpu().numpy()
    return {"worst_answer_mean_gap": float((probs - rp).abs().mean()),
            "worst_answer_sens_gap": sens_gap(probs, rp),
            **{f"worst_answer_off_{t}": v
               for t, v in zip(OFF, off_shares(probs, rp))},
            "worst_hard_own_mismatch": float(
                (hard != harden(probs)).any(-1).mean()),
            "worst_hard_mismatch": float((hard != rh).mean()),
            "worst_hard_mismatch_decided": float((differs & decided).mean()),
            "worst_undecided_share": float((~decided).mean()),
            "worst_dice_gap": max(abs(a - b) for a, b in zip(dice, rd)),
            "worst_dice_own_gap": max(abs(a - b) for a, b in zip(
                dice, dice_of(hard, gt)))}


def worst(per_answer):
    """Each reading's worst over the answers."""
    return {k: max(r[k] for r in per_answer) for k in per_answer[0]}


def reference_answer(vol, state, cfg, prec, device):
    """(probabilities [H, W, D, 4], hard n-hot, Dice per class 1..3, the
    n-hot ground-truth regions)."""
    image = torch.from_numpy(vol["image"]).to(device)[None]
    sp = image.shape[1:4]
    pads = [(-s) % m for s, m in zip(sp, MULTIPLES)]
    image = F.pad(image, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
    with torch.no_grad():
        logits = nets.segtran3d(image, state, cfg["model"], prec)
    probs = torch.sigmoid(logits[0, :sp[0], :sp[1], :sp[2]])
    bg, et, wt, tc = probs.unbind(-1)
    probs = torch.stack([bg, et, torch.maximum(torch.maximum(et, wt), tc),
                         torch.maximum(et, tc)], -1)
    hard = harden(probs)
    gt = regions(vol["label"])
    return probs, hard, dice_of(hard, gt), gt


def draws(ctx, n_pool):
    """(the order volumes are evaluated in, the sampled answers)."""
    tr = ctx.workload["traffic"]
    rng = inputs.rng(ctx.seed, 5)
    order = rng.permutation(np.tile(np.arange(n_pool), 64))
    sample = set(rng.choice(tr["check_within"], size=tr["check_answers"],
                            replace=False).tolist())
    return order, sample


def control(ctx, prec):
    """Readings of the reference in ``prec`` put in the program's place,
    on the volumes a run of this seed would check."""
    from segtran_tpu_torch.cli import test3d
    tr, dev = ctx.workload["traffic"], ctx.device
    argv = list(ctx.config["eval_argv"]) + ["--cpdir", "unused", "--device",
                                            dev.type]
    args = test3d.build_argparser().parse_args(argv)
    with torch.device("meta"):
        meta, _ = test3d.build_model_and_config(args,
                                                test3d.task_settings(args))
    state = inputs.seeded_state(inputs.model_shapes(meta), ctx.seed, dev)
    size = tuple(tr.get("volume_size", ctx.config["model"]["volume_size"]))
    order, sample = draws(ctx, tr["pool"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    per_answer = []
    for j in sorted(sample):
        vol = inputs.volume(size, ctx.seed * 16 + int(order[j]), dev)
        ref = reference_answer(vol, state, ctx.config, nets.FP32, dev)
        low = reference_answer(vol, state, ctx.config, prec, dev)
        per_answer.append(compare(low[:3], ref))
    return worst(per_answer)


def run(ctx) -> H.Outcome:
    from segtran_tpu_torch.cli import test3d
    with planted_post(test3d, ctx.faults):
        return measure(ctx)


def measure(ctx) -> H.Outcome:
    tr, dev = ctx.workload["traffic"], ctx.device
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    test3d, model, args, task, state = make_model(ctx)
    size = tuple(tr.get("volume_size", ctx.config["model"]["volume_size"]))
    pool = [inputs.volume(size, ctx.seed * 16 + j, dev)
            for j in range(tr["pool"])]
    model_fn = plant(model, ctx.faults)
    if ctx.trace:
        model_fn = ctx.spans.wrap("wholevol.forward", model_fn, sync)
    evaluate = ctx.spans.wrap("wholevol.volume", test3d.evaluate_volume, sync)
    for vol in pool[:2]:                 # warm: one shape, built then run
        test3d.evaluate_volume(model_fn, vol, args, task, dev)
    sync()
    order, sample = draws(ctx, tr["pool"])
    from segtran_tpu_torch.kernels import expansion_epilogue as epi
    from segtran_tpu_torch.kernels import squeezed_attention as sa
    kept, dice, failed = {}, [], 0
    t0, t0_ns = time.perf_counter(), time.time_ns()
    setup_s = ctx.setup_done()
    # a traced run profiles the volumes of the window's last trace_s
    # seconds and reads its host-side metrics from the volumes before
    t_slice = ctx.seconds - tr["trace_s"] if ctx.trace else float("inf")
    i, traced = 0, {}
    while True:
        el = time.perf_counter() - t0
        if el >= ctx.seconds:
            break
        if not traced and el >= t_slice:
            traced.update(n0=(epi.fused_private_output_pool.launches,
                              sa.fused_cross_attention.launches),
                          items=len(dice), el=el, t_ns=time.time_ns())
            ctx.tracer.start()
        vol = pool[order[i % len(order)]]
        try:
            probs, hard, metrics = evaluate(model_fn, vol, args, task, dev)
        except RuntimeError as e:       # a failed volume counts as missing
            ctx.log(f"volume {i} failed: {e!r}")
            failed += 1
            i += 1
            continue
        dice.append(metrics["dice"])
        if i in sample:
            kept[i] = (probs.clone(), hard, metrics["dice"])
        del probs
        i += 1
    sync()
    window = time.perf_counter() - t0
    if traced:
        traced["n1"] = (epi.fused_private_output_pool.launches,
                        sa.fused_cross_attention.launches)
        ctx.tracer.stop()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    del model, model_fn
    if cuda:
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    readings = {}
    if kept:
        state = {k: v.to(dev) for k, v in state.items()}
        readings = worst([
            compare(answer, reference_answer(pool[order[j % len(order)]],
                                             state, ctx.config, nets.FP32,
                                             dev))
            for j, answer in kept.items()])
    checks = [H.Check(name, readings.get(name, float("nan")), limit)
              for name, limit in ctx.workload["checks"].items()]
    ctx.log(f"readings: {readings} over {len(kept)} answers")
    n = len(dice)
    ctx.log(f"wholevol: {n} volumes in {window:.3f} s, {window / max(n, 1):.4f}"
            f" s per volume, Dice (random weights) of the first "
            f"{[round(x, 4) for x in dice[0]] if dice else None}")
    counters = {"volumes": n,
                "traced_items": n - traced["items"] if traced else 0,
                "mfu_items": traced.get("items", n),
                "mfu_seconds": traced.get("el", window),
                "window_t1_ns": traced.get("t_ns", time.time_ns()),
                "readings": readings,
                "window_t0_ns": t0_ns, "state_shapes": {
                    k: tuple(v.shape) for k, v in state.items()}}
    if traced:
        counters["traced_launches"] = {
            "epilogue": traced["n1"][0] - traced["n0"][0],
            "flash_fwd": traced["n1"][1] - traced["n0"][1]}
    e2e = {"volume_s": window / max(n, 1), "setup_s": setup_s}
    return H.Outcome(attempted=n + failed, failed=failed, end_to_end=e2e,
                     checks=checks, memory_peak_bytes=peak, window_s=window,
                     counters=counters)
