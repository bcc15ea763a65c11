"""The rank side of the port's parallel tests (tests/_torch_dist.launch):
each worker runs on one gloo rank, reads its inputs from .npz / .pt files
and returns numpy arrays. Imports only torch, numpy and the port -- the
JAX oracle runs in the parent test process."""
import os

import numpy as np
import torch
import torch.distributed as dist

from _torch_dist import load_inputs

# the tiny flagship-shaped Segtran2d of tests/test_torch_train2d.py:
# eff-tiny, 3 classes, 8 attractors, --layercompress 1,1,2
TINY2D = dict(backbone_type="eff-tiny", num_classes=3, num_attractors=8,
              hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
RATIOS2D = (1.0, 1.0, 2.0)
MIX_W = 0.3


def tiny_segtran2d():
    from segtran_tpu_torch.configs.base import Segtran2dConfig
    from segtran_tpu_torch.models.segtran2d import Segtran2d
    cfg = Segtran2dConfig(**TINY2D).derive(translayer_compress_ratios=RATIOS2D)
    model = Segtran2d(cfg)
    for blk in model.backbone._blocks:
        blk.drop_rate = 0.0
    return model, cfg


def mixed_loss_fn():
    """The 2-D loss plus MIX_W x the whole-batch dice_loss_mix of class 1:
    a batch-joint term."""
    from segtran_tpu_torch.ops.losses import dice_loss_mix
    from segtran_tpu_torch.train.trainer import make_loss_fn
    base = make_loss_fn(3, (0.0, 1.0, 2.0))

    def loss_fn(logits, mask):
        loss, metrics = base(logits, mask)
        mix = dice_loss_mix(torch.sigmoid(logits[..., 1].float()),
                            mask[..., 1])
        loss = loss + MIX_W * mix
        return loss, dict(metrics, loss=loss, mix_loss=mix)
    return loss_fn


def segtran2d_steps(rank, world, out_dir, inputs, sd, tp=1, ep=False,
                    steps=2):
    """``steps`` train steps of the tiny Segtran2d on this rank's rows of
    the global batch (``TrainMesh`` over every rank, ``--tp tp [--ep]``);
    returns the losses and, on rank 0, the full state_dict after them,
    with the optimizer state's element count on this rank."""
    from segtran_tpu_torch.ops.norm import shard_rows
    from segtran_tpu_torch.parallel.mesh import TrainMesh
    from segtran_tpu_torch.train.trainer import (build_optimizer,
                                                 make_train_step)
    x = load_inputs(inputs)
    model, cfg = tiny_segtran2d()
    model.load_state_dict(torch.load(sd, weights_only=True), strict=True)
    opt = build_optimizer(model, lr=2e-4, decay=1e-4, t_total=4,
                          warmup_ratio=0.5)
    par = TrainMesh(model, opt, world, tp,
                    expert_dim_size=cfg.num_modes if ep else None)
    step = par.wrap(make_train_step(model, par.optimizer, mixed_loss_fn(),
                                    grad_clip=0.1))
    rows = shard_rows(x["image"].shape[0], *par.shard)
    batch = {k: torch.from_numpy(x[k][rows]) for k in ("image", "mask")}
    losses, mixes = [], []
    for _ in range(steps):
        m = step(batch)
        losses.append(float(m["loss"]))
        mixes.append(float(m["mix_loss"]))
    out = {"losses": np.array(losses), "mix": np.array(mixes)}
    inner = par.optimizer.optimizer if par.state is not None else opt
    out["moment_numel"] = np.array(sum(
        st["m"].numel() for st in inner.state.values()))
    out["param_numel"] = np.array(sum(p.numel() for p in model.parameters()))
    if par.state is not None:
        out["sharded"] = np.array(sorted(
            f"{k}:{v.dim}" for k, v in par.state.spec.items()
            if hasattr(v, "dim")))
        out["held_numel"] = np.array(sum(
            p.numel() for p in model.parameters()) + sum(
            t.numel() for t in par.state.full_of))
    sd_after = par.state_dict()
    par.finish()
    if rank == 0:
        torch.save(sd_after, os.path.join(out_dir, "after.pt"))
        out["whole_numel"] = np.array(sum(p.numel()
                                          for p in model.parameters()))
    return out


def batch_norms(rank, world, out_dir, inputs):
    """ops.norm.BatchNorm and efficientnet.FoldedBatchNorm in training on
    this rank's rows within global_batch: outputs, input gradients of
    sum(y * w), the running statistics after."""
    from segtran_tpu_torch.nn.backbones.efficientnet import FoldedBatchNorm
    from segtran_tpu_torch.ops.norm import BatchNorm, global_batch
    from segtran_tpu_torch.parallel.mesh import make_mesh, shard_batch_to_mesh
    x = load_inputs(inputs)
    mesh = make_mesh(world)
    out = {}
    for name, bn in (("bn", BatchNorm(x["x"].shape[1], momentum=0.9)),
                     ("folded", FoldedBatchNorm(x["x"].shape[1]))):
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(x["weight"]))
            bn.bias.copy_(torch.from_numpy(x["bias"]))
        xs = torch.from_numpy(shard_batch_to_mesh(x["x"], mesh)
                              ).requires_grad_()
        w = torch.from_numpy(shard_batch_to_mesh(x["w"], mesh))
        bn.train()
        with global_batch(mesh.get_group("data")):
            y = bn(xs, torch.float32) if name == "bn" else \
                bn.run(xs, torch.float32)
            (y * w).sum().backward()
        out[name + "_y"] = y.detach().numpy()
        out[name + "_dx"] = xs.grad.numpy()
        dw = bn.weight.grad.clone()
        dist.all_reduce(dw)          # the global sum's weight gradient
        out[name + "_dw"] = dw.numpy()
        out[name + "_mean"] = bn.running_mean.numpy()
        out[name + "_var"] = bn.running_var.numpy()
    return out


def draws(rank, world, out_dir, batch):
    """draw_2d's rows of this rank under global_batch, from a generator
    seeded as train2d seeds it."""
    from segtran_tpu_torch.data.augment import (Aug2dConfig, draw_2d,
                                                rot_flip_draws)
    from segtran_tpu_torch.ops.norm import global_batch, global_rows
    from segtran_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(world)
    gen = torch.Generator().manual_seed(7)
    cfg = Aug2dConfig(randscale=0.2, do_affine=True,
                      robust_aug=("brightness",))
    with global_batch(mesh.get_group("data")):
        d = global_rows(draw_2d, batch // world, cfg, gen)
        k, fh, fw = global_rows(rot_flip_draws, batch // world, gen)
    return dict(d, rot_k3=k, flip_h3=fh, flip_w3=fw)


def topology(rank, world, out_dir, init_method, tp=1):
    """init_multihost from the launcher's env (gloo for the CPU) with its
    rank line, is_master, --ndevices against the world size,
    replicate_to_mesh, shard_batch_to_mesh on a (data, model) mesh, and
    from_master."""
    import contextlib
    import io
    from segtran_tpu_torch.parallel.mesh import (make_mesh, replicate_to_mesh,
                                                 resolve_ndevices,
                                                 shard_batch_to_mesh)
    from segtran_tpu_torch.parallel.multihost import (from_master,
                                                      init_multihost,
                                                      is_master)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        topo = init_multihost("cpu", init_method=init_method, verbose=True)
    errors = []
    for nd, t in ((world + 1, 1), (world, 3)):
        try:
            resolve_ndevices(nd, t)
            errors.append("")
        except ValueError as e:
            errors.append(str(e))
    mesh = make_mesh(world, axes=("data", "model"),
                     shape=(world // tp, tp))
    torch.manual_seed(rank)
    lin = torch.nn.Linear(3, 2)
    replicate_to_mesh(lin, mesh)
    batch = {"x": np.arange(12).reshape(12, 1)}
    return dict(topo=np.array([topo["process_index"], topo["process_count"],
                               topo["local_devices"],
                               topo["global_devices"]]),
                line=np.array(buf.getvalue().strip()),
                master=np.array(is_master()),
                ndevices=np.array([resolve_ndevices(-1), resolve_ndevices(
                    world)]),
                errors=np.array(errors), weight=lin.weight.detach().numpy(),
                rows=shard_batch_to_mesh(batch, mesh)["x"][:, 0],
                job=np.array(from_master(f"job-{rank}")),
                backend=np.array(dist.get_backend()))


def primitives(rank, world, out_dir, inputs, encoder_sd=None,
               hetero_sd=None, cfg_kw=None, hetero_kw=None):
    """The context-parallel squeeze (keys sharded) and expand (queries
    sharded), the mode-sharded FFN aggregate (modes sharded), and gpipe:
    a toy stack at M = 1, 2, 4 with its gradients, a pytree hand-off, and
    the translayer stages (uniform; --layercompress 1,1,2,2 padded) on a
    pipeline of the first ``len(layers)`` ranks."""
    from segtran_tpu_torch.parallel import context_parallel as cp
    from segtran_tpu_torch.parallel.expert import mode_sharded_ffn_aggregate
    from segtran_tpu_torch.parallel.mesh import make_mesh
    from segtran_tpu_torch.parallel.spatial import slab_bounds
    x = {k: torch.from_numpy(v) for k, v in load_inputs(inputs).items()}
    mesh = make_mesh(world, axes=("data", "model"), shape=(1, world))
    g = mesh.get_group("model")
    out = {}
    n = x["k"].shape[1]
    lo, hi = slab_bounds(n, rank, world)
    out["squeeze"] = cp.sharded_cross_attention(
        x["q"], x["k"][:, lo:hi], x["v"][:, lo:hi], g, attn_clip=5.0)
    qlo, qhi = slab_bounds(x["eq"].shape[1], rank, world)
    out["expand"] = cp.token_sharded_expand_attention(
        x["eq"][:, qlo:qhi], x["ek"], x["ev"], g)
    m = x["fx"].shape[1] // world
    ms = slice(rank * m, (rank + 1) * m)
    out["aggregate"] = mode_sharded_ffn_aggregate(
        x["fx"][:, ms], x["fk"][ms], x["fb"][ms], x["sk"], x["sb"], g)
    # gpipe: a toy tanh stack, one stage per rank
    from segtran_tpu_torch.parallel.pipeline import gpipe
    w = x["pw"][rank].clone().requires_grad_()
    bias = x["pb"][rank].clone().requires_grad_()

    def stage(p, xb):
        return torch.tanh(xb @ p["w"] + p["b"])
    for n_micro in (1, 2, 4):
        out[f"toy{n_micro}"] = gpipe(stage, {"w": w, "b": bias}, x["px"], g,
                                     n_micro).detach()
    px = x["px"].clone().requires_grad_()
    y = gpipe(stage, {"w": w, "b": bias}, px, g, 4)
    gw, gb, gx = torch.autograd.grad((y ** 2).sum(), (w, bias, px))
    out.update(grad_w=gw, grad_b=gb, grad_x=gx)

    def pair_stage(p, xt):
        v, side = xt
        return torch.tanh(v @ p["w"] + p["b"]) + side, side
    v, side = gpipe(pair_stage, {"w": w.detach(), "b": bias.detach()},
                    (x["px"], x["pside"]), g, 2)
    out.update(pair_v=v, pair_side=side)
    # the fusion encoder's translayers pipelined, uniform and padded
    from segtran_tpu_torch.configs.base import Segtran2dConfig
    from segtran_tpu_torch.parallel import pipeline as pl
    for label, sd_path, kw in (("uniform", encoder_sd, cfg_kw),
                               ("hetero", hetero_sd, hetero_kw)):
        cfg = Segtran2dConfig(**kw["cfg"]).derive(
            translayer_compress_ratios=tuple(kw["ratios"]))
        s = cfg.num_translayers
        sub = dist.new_group(list(range(s)))
        if rank >= s:
            continue
        sd = torch.load(sd_path, weights_only=True)
        if label == "uniform":
            params = pl.stack_translayer_params(sd, s, rank)
            fn = pl.make_translayer_stage(cfg)
        else:
            params, shapes = pl.stack_translayer_params_padded(sd, s, rank)
            fn = pl.make_hetero_translayer_stage(cfg, shapes, sub)
        y, _, _ = gpipe(fn, params, (x[label + "_vfeat"], x[label + "_pos"],
                                     x[label + "_mask"]), sub, 2)
        out[label] = y.detach()
    return {k: v.detach().numpy() for k, v in out.items()}


def cli(rank, world, out_dir, module, argv):
    """``segtran_tpu_torch.cli.<module>.main(argv)`` on this rank (the
    group is up, as torchrun's env would have it); returns the checkpoint
    directory (train) or the per-class Dice of each iteration (test3d)."""
    import importlib
    import sys
    # TensorBoard's writer takes its TensorFlow-free path: where
    # TensorFlow is installed, its import alone costs each rank seconds
    sys.modules["tensorflow"] = None
    mod = importlib.import_module(f"segtran_tpu_torch.cli.{module}")
    res = mod.main(list(argv))
    if isinstance(res, dict):
        return {"dice": np.array([res[k] for k in sorted(res)])}
    return {"ckpt": np.array(res)}


def batch_joint_losses(rank, world, out_dir, inputs):
    """The batch-joint loss terms on this rank's rows within global_batch:
    dice_loss_mix, the 2-D attention-consistency loss and the contrast
    losses, with the input gradients of their sum."""
    from segtran_tpu_torch.ops.losses import dice_loss_mix
    from segtran_tpu_torch.ops.norm import global_batch
    from segtran_tpu_torch.parallel.mesh import make_mesh, shard_batch_to_mesh
    from segtran_tpu_torch.train.contrast import calc_contrast_losses
    from segtran_tpu_torch.train.da import attention_consistency_loss
    x = {k: torch.from_numpy(v) for k, v in load_inputs(inputs).items()}
    mesh = make_mesh(world)
    rows = {k: shard_batch_to_mesh(x[k], mesh).clone()
            for k in ("score", "mask", "in_s", "out_s", "feat")}
    for k in ("score", "in_s", "feat"):
        rows[k].requires_grad_()
    with global_batch(mesh.get_group("data")):
        mix = dice_loss_mix(rows["score"], rows["mask"][..., 1])
        ac = attention_consistency_loss([(rows["in_s"], rows["out_s"])],
                                        rows["mask"], (4, 4))
        pos, neg = calc_contrast_losses(
            rows["feat"], rows["mask"], x["bank"], x["valid"].bool(),
            x["cls_w"], neg_offsets=x["offsets"].long(),
            do_neg_contrast=True)
        (mix + ac + pos - neg).backward()
    return dict(mix=mix.detach(), ac=ac.detach(), pos=pos.detach(),
                neg=neg.detach(), d_score=rows["score"].grad,
                d_in=rows["in_s"].grad, d_feat=rows["feat"].grad)
