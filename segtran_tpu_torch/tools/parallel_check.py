"""Multi-rank check of ``parallel/`` on the process group torchrun starts:
each result of N ranks against the same computation in one process.

    torchrun --standalone --nproc_per_node 4 \\
        -m segtran_tpu_torch.tools.parallel_check [--device cpu]

Four ranks: a (2 data x 2 model) mesh for ``--tp 2``, four stages, four
key or mode shards. On the GPU (NCCL, ``--device cuda``, the default) at
the recipes' widths, fp32 with TF32 off unless named; with ``--device
cpu`` (gloo) at the CPU tests' tiny widths, to rehearse the run:

- ``dp`` / ``tp`` / ``tp_ep``: two train steps of Segtran2d (the fundus
  flagship: eff-b4, 1792->1792->896->448, 4 modes, 256 attractors, 288^2,
  global batch 8; dropout off) through ``TrainMesh`` on every rank --
  data parallel, ``--tp 2``, ``--tp 2 --ep`` -- against the same two
  steps of one process on the global batch (rank 0): the losses, and the
  whole update p(2) - p(0) by relative Frobenius error;
- ``context``: ``sharded_cross_attention`` with the BraTS in-squeeze's
  8640 keys split over the ranks (the flash forward per rank, merged by
  lse), bf16 and fp32, against one ``fused_cross_attention`` call;
- ``expert``: ``mode_sharded_ffn_aggregate`` with one mode per rank
  against ``MMPrivateMid`` + ``LearnedSoftAggregate`` (F = 896);
- ``pipeline``: ``gpipe`` over four uniform translayer stages (D = 1792)
  and over the three ``--layercompress 1,1,2,2`` stages, outputs and the
  stages' parameter gradients (each stage's as one vector) against the
  sequential layers;
- ``spatial``: test3d's ``evaluate_volume`` through
  ``sharded_whole_volume_apply`` on a (1, 4) mesh (the BraTS Segtran3d,
  bf16, ``--fused --fusedepi``, a 160x192x144 volume) against the model
  itself: probabilities of the rank's slab and the per-class Dice.

Rank 0 prints one JSON line per check and, last, ``{"ok": ..., "world":
4, "backend": ..., "device": <each card's name and power limit>}``; the
command exits non-zero if a check fails.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

WORLD = 4
# the one-process result against the N ranks': losses (relative), the
# update by relative Frobenius error (fp32; the summation order of the
# batch statistics and the gradient sums differs, and BertAdam's
# m / (sqrt(v) + eps) moves noise-sized gradients by whole steps)
LOSS_RTOL = 1e-4
UPDATE_TOL = 0.05
# context parallel: max |err| / (1 + |ref|) against one call (bf16 rounds
# each rank's output once more before the merge)
CP_TOL = {"bf16": 3e-2, "fp32": 1e-4}
EXACT_TOL = 1e-4               # expert, pipeline (fp32 sums reordered)
PROB_TOL = 1e-3                # the sharded volume's probabilities (bf16)
DICE_TOL = 1e-4                # and its Dice (a voxel at 0.5 may flip)


def _say(rank, row):
    if rank == 0:
        print(json.dumps(row), flush=True)


def _all_ok(ok: bool, dev) -> bool:
    """True when every rank's check passed."""
    t = torch.tensor([0.0 if ok else 1.0], device=dev)
    dist.all_reduce(t)
    return float(t) == 0.0


def _step_models(dev, small):
    from segtran_tpu_torch.configs.base import Segtran2dConfig
    from segtran_tpu_torch.models.segtran2d import Segtran2d
    from segtran_tpu_torch.nn.init import init_with_reference_schemes
    kw = dict(num_classes=3, hidden_dropout_prob=0.0,
              attention_probs_dropout_prob=0.0)
    if small:
        cfg = Segtran2dConfig(backbone_type="eff-tiny", num_attractors=8,
                              **kw).derive(
                                  translayer_compress_ratios=(1.0, 1.0, 2.0))
    else:
        cfg = Segtran2dConfig(backbone_type="eff-b4", remat_blocks=True,
                              **kw).derive(
                                  translayer_compress_ratios=(1.0, 1.0, 2.0,
                                                              2.0))
    model = init_with_reference_schemes(Segtran2d(cfg), cfg, 0)
    for blk in model.backbone._blocks:
        blk.drop_rate = 0.0
    return model.to(dev), cfg


def _steps(model, cfg, batch, dev, tp=1, ep=False, group=True):
    """Two steps; returns (losses, full state_dict after, seconds)."""
    from segtran_tpu_torch.ops.norm import shard_rows
    from segtran_tpu_torch.parallel.mesh import TrainMesh
    from segtran_tpu_torch.train.trainer import (build_optimizer,
                                                 make_loss_fn,
                                                 make_train_step)
    opt = build_optimizer(model, lr=2e-4, decay=1e-4, t_total=4,
                          warmup_ratio=0.5)
    loss_fn = make_loss_fn(3, (0.0, 1.0, 2.0))
    if group:
        par = TrainMesh(model, opt, -1, tp,
                        expert_dim_size=cfg.num_modes if ep else None)
        step = par.wrap(make_train_step(model, par.optimizer, loss_fn,
                                        grad_clip=0.1))
        rows = shard_rows(batch["image"].shape[0], *par.shard)
        batch = {k: v[rows] for k, v in batch.items()}
    else:
        step = make_train_step(model, opt, loss_fn, grad_clip=0.1)
    _sync(dev)
    t0 = time.perf_counter()
    losses = [float(step(batch)["loss"]) for _ in range(2)]
    _sync(dev)
    secs = time.perf_counter() - t0
    sd = par.state_dict() if group else model.state_dict()
    if group:
        par.finish()
    return losses, {k: v.detach().float().cpu().clone()
                    for k, v in sd.items()}, secs


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def step_check(rank, dev, small, label, tp=1, ep=False):
    gen = torch.Generator().manual_seed(5)
    b, hw = (4, 64) if small else (8, 288)
    batch = {"image": torch.randn(b, hw, hw, 3, generator=gen),
             "mask": torch.nn.functional.one_hot(
                 torch.randint(0, 3, (b, hw, hw), generator=gen), 3).float()}
    batch = {k: v.to(dev) for k, v in batch.items()}
    model, cfg = _step_models(dev, small)
    p0 = {k: v.detach().float().cpu().clone()
          for k, v in model.state_dict().items()}
    losses, after, secs = _steps(model, cfg, batch, dev, tp, ep)
    del model
    row = {"check": label, "losses": losses, "seconds": secs}
    ok = True
    if rank == 0:
        ref, rcfg = _step_models(dev, small)
        ref_losses, ref_after, ref_secs = _steps(ref, rcfg, batch, dev,
                                                 group=False)
        del ref
        names = [k for k in p0 if p0[k].is_floating_point()
                 and not k.endswith(("running_mean", "running_var"))]
        got = torch.cat([(after[k] - p0[k]).reshape(-1) for k in names])
        want = torch.cat([(ref_after[k] - p0[k]).reshape(-1)
                          for k in names])
        rel = float((got - want).norm() / want.norm())
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                           ref_losses))
        ok = rel < UPDATE_TOL and loss_rel < LOSS_RTOL
        row.update(one_process_losses=ref_losses, loss_rel=loss_rel,
                   update_rel_fro=rel, one_process_seconds=ref_secs)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    row["ok"] = _all_ok(ok, dev)
    return row


def context_check(rank, dev, small):
    from segtran_tpu_torch.kernels.squeezed_attention import (
        fused_cross_attention)
    from segtran_tpu_torch.parallel.context_parallel import (
        sharded_cross_attention)
    from segtran_tpu_torch.parallel.spatial import slab_bounds
    g, nq, n, d, f = (2, 16, 64, 32, 48) if small else (1, 1024, 8640, 1024,
                                                        1024)
    rows, ok = [], True
    for dname, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        gen = torch.Generator().manual_seed(3)
        q, k, v = (torch.randn(*s, generator=gen).to(dev, dt)
                   for s in ((g, nq, d), (g, n, d), (g, n, f)))
        lo, hi = slab_bounds(n, rank, WORLD)
        out = sharded_cross_attention(q, k[:, lo:hi], v[:, lo:hi],
                                      dist.group.WORLD)
        ref = fused_cross_attention(q, k, v)
        err = float(((out.float() - ref.float()).abs()
                     / (1 + ref.float().abs())).max())
        ok = ok and err < CP_TOL[dname]
        rows.append({"dtype": dname, "max_rel_err": err})
    return {"check": "context", "shape": [g, nq, n, d, f], "cases": rows,
            "ok": _all_ok(ok, dev)}


def expert_check(rank, dev, small):
    from segtran_tpu_torch.nn.attention import (LearnedSoftAggregate,
                                                MMPrivateMid)
    from segtran_tpu_torch.parallel.expert import mode_sharded_ffn_aggregate
    b, m, u, f = (2, WORLD, 6, 16) if small else (2, WORLD, 256, 896)
    torch.manual_seed(0)
    ffn = MMPrivateMid(m, f).to(dev).eval()
    agg = LearnedSoftAggregate(f, group_dim=1).to(dev)
    with torch.no_grad():
        ffn.group_linear.weight.normal_(0, 1 / math.sqrt(f))
        x = torch.randn(b, m, u, f, generator=torch.Generator().manual_seed(
            1)).to(dev)
        ref = agg(ffn(x))
        out = mode_sharded_ffn_aggregate(
            x[:, rank:rank + 1], ffn.group_linear.weight[rank:rank + 1],
            ffn.group_linear.bias[rank:rank + 1], agg.feat2score.weight.t(),
            agg.feat2score.bias, dist.group.WORLD)
    err = float(((out - ref).abs() / (1 + ref.abs())).max())
    return {"check": "expert", "shape": [b, m, u, f], "max_rel_err": err,
            "ok": _all_ok(err < EXACT_TOL, dev)}


def _seeded(name, t, gen):
    """A seeded stand-in for an initialised tensor: kernels normal /
    sqrt(fan-in), norm scales 1 + 0.1 N, biases 0.1 N."""
    if not t.is_floating_point():
        return t
    r = torch.randn(t.shape, generator=gen)
    if t.dim() >= 2:
        return r / math.sqrt(t.shape[-1])
    return 1.0 + 0.1 * r if name.endswith("weight") else 0.1 * r


def pipeline_check(rank, dev, small):
    """gpipe's outputs and parameter gradients against the sequential
    stages on every rank (each rank compares its own stage)."""
    from segtran_tpu_torch.configs.base import Segtran2dConfig
    from segtran_tpu_torch.nn.encoder import SegtranFusionEncoder
    from segtran_tpu_torch.parallel import pipeline as pl
    rows, ok = [], True
    for label, ratios in (("uniform", (1.0,) * (WORLD + 1)),
                          ("hetero", (1.0, 1.0, 2.0, 2.0))):
        cfg = Segtran2dConfig(
            backbone_type="eff-tiny" if small else "eff-b4", num_classes=3,
            num_attractors=8 if small else 256, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0).derive(
                translayer_compress_ratios=ratios)
        s = cfg.num_translayers
        sub = dist.new_group(list(range(s)))
        if rank >= s:
            continue
        gen = torch.Generator().manual_seed(2)
        sd = {k: _seeded(k, v, gen)
              for k, v in SegtranFusionEncoder(cfg).state_dict().items()}
        b, n, c = 4, 16 if small else 1296, cfg.trans_in_dim
        x = (torch.randn(b, n, c, generator=gen).to(dev),
             torch.randn(b, n, c, generator=gen).to(dev),
             torch.ones(b, n, 1, device=dev))
        stages = []
        for i in range(s):
            params = {k: v.to(dev).requires_grad_() for k, v in
                      pl.stack_translayer_params_padded(sd, s, i)[0].items()}
            stages.append((params, pl._TranslayerStage(cfg, i).to(dev)))
        mine = stages[rank][0]
        if label == "uniform":
            fn = pl.make_translayer_stage(cfg)
        else:
            fn = pl.make_hetero_translayer_stage(
                cfg, pl.stack_translayer_params_padded(sd, s, rank)[1], sub)
        y, _, _ = pl.gpipe(fn, mine, x, sub, 2)
        grads = torch.autograd.grad(y.square().sum(), list(mine.values()))
        # the sequential layers, the hand-off padded as the pipeline's
        v = x[0]
        for params, module in stages:
            out = torch.func.functional_call(
                module, params, (v[..., :module.d_in], x[1], x[2]))
            v = torch.nn.functional.pad(out, (0, c - out.shape[-1]))
        want = torch.autograd.grad(v.square().sum(),
                                   list(stages[rank][0].values()))
        y_err = float(((y - v).abs() / (1 + v.abs())).max().detach())
        # the stage's gradient as one vector: some tensors' are zero by
        # structure (the mode softmax's shared shift) and rounding noise
        g, w = (torch.cat([t.reshape(-1) for t in ts])
                for ts in (grads, want))
        g_err = float((g - w).norm() / w.norm())
        ok = ok and y_err < EXACT_TOL and g_err < EXACT_TOL
        rows.append({"stages": label, "max_rel_err": y_err,
                     "grad_rel_fro": g_err})
    return {"check": "pipeline", "cases": rows, "ok": _all_ok(ok, dev)}


def spatial_check(rank, dev, small):
    from segtran_tpu_torch.cli.test3d import (build_argparser,
                                              build_model_and_config,
                                              evaluate_volume, task_settings)
    from segtran_tpu_torch.models.segtran3d import init_segtran3d
    from segtran_tpu_torch.parallel.mesh import make_mesh
    from segtran_tpu_torch.parallel.spatial import (
        sharded_whole_volume_apply, slab_bounds)
    argv = ["--task", "brats", "--wholevol", "--fused", "--fusedepi",
            "--cpdir", "unused", "--device", dev.type]
    argv += (["--attractors", "8"] if small else
             ["--translayers", "1", "--attractors", "1024", "--bf16"])
    args = build_argparser().parse_args(argv)
    task = task_settings(args)
    model, _ = build_model_and_config(args, task)
    model = init_segtran3d(model, seed=0).to(dev).eval()
    shape = (40, 40, 20) if small else (160, 192, 144)
    rng = np.random.RandomState(5)
    lab = np.zeros(shape, np.uint8)
    h, w, d = shape
    lab[h // 4:3 * h // 4, w // 4:3 * w // 4, d // 4:3 * d // 4] = 2
    lab[h // 3:h // 2, w // 3:w // 2, d // 3:d // 2] = 1
    sample = {"image": rng.rand(*shape, 4).astype(np.float32), "label": lab}
    fn = sharded_whole_volume_apply(
        model, make_mesh(WORLD, axes=("data", "model"), shape=(1, WORLD)))
    _sync(dev)
    t0 = time.perf_counter()
    probs, _, metrics = evaluate_volume(fn, sample, args, task, dev)
    _sync(dev)
    secs = time.perf_counter() - t0
    ref, _, ref_metrics = evaluate_volume(model, sample, args, task, dev)
    lo, hi = slab_bounds(-(-shape[0] // 16) * 16, rank, WORLD)
    hi = max(min(hi, shape[0]), lo)
    p_err = float((probs - ref[lo:hi]).abs().max()) if hi > lo else 0.0
    d_err = max(abs(a - b) for a, b in zip(metrics["dice"],
                                           ref_metrics["dice"]))
    return {"check": "spatial", "shape": list(shape), "seconds": secs,
            "prob_diff": p_err, "dice": metrics["dice"],
            "dice_diff": d_err,
            "ok": _all_ok(p_err <= PROB_TOL and d_err <= DICE_TOL, dev)}


def _card(dev) -> str:
    """The card's name and power limit as nvidia-smi gives them (each
    card's), or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    import subprocess
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
        if r.returncode == 0 and r.stdout.strip():
            return "; ".join(r.stdout.strip().splitlines())
    except (OSError, subprocess.TimeoutExpired):
        pass
    return f"{torch.cuda.get_device_name(dev)}, power limit not readable"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default; NCCL) or cpu (gloo, tiny widths)")
    args = ap.parse_args(argv)
    from segtran_tpu_torch import resolve_device
    from segtran_tpu_torch.parallel.multihost import init_multihost
    dev = resolve_device(args.device)
    topo = init_multihost(dev, verbose=True)
    if topo["process_count"] != WORLD:
        print(f"parallel_check needs {WORLD} ranks (torchrun "
              f"--nproc_per_node {WORLD}), got {topo['process_count']}",
              file=sys.stderr)
        return 2
    rank = dist.get_rank()
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    small = dev.type == "cpu"
    if small:
        torch.set_num_threads(1)
    results = []
    try:
        for check in (lambda: step_check(rank, dev, small, "dp"),
                      lambda: step_check(rank, dev, small, "tp", tp=2),
                      lambda: step_check(rank, dev, small, "tp_ep", tp=2,
                                         ep=True),
                      lambda: context_check(rank, dev, small),
                      lambda: expert_check(rank, dev, small),
                      lambda: pipeline_check(rank, dev, small),
                      lambda: spatial_check(rank, dev, small)):
            row = check()
            results.append(row)
            _say(rank, row)
        ok = all(r["ok"] for r in results)
        _say(rank, {"ok": ok, "world": WORLD, "backend": dist.get_backend(),
                    "device": _card(dev)})
    finally:
        dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
