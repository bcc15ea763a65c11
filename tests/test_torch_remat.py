"""Activation recompute (``nn/remat.py``): a train step with ``remat`` /
``remat_blocks`` gives the loss, the gradients and the BatchNorm running
statistics of the same step without it -- the statistics move once, and
dropout and drop-connect redraw the forward's masks in the recompute."""
import dataclasses

import numpy as np
import torch

from _torch_train3d import ARGV, SHAPE
from _torch_parity import one_torch_thread  # noqa: F401


def _grads(model):
    return {n: p.grad.clone() for n, p in model.named_parameters()
            if p.grad is not None}


def _stats(model):
    return {n: b.clone() for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))}


def _assert_same(a, b):
    """Recompute repeats the same operations in the same order on the same
    inputs: equal to the last bit but for the order in which autograd sums
    a gradient's contributions, which the checkpoint can change."""
    assert set(a) == set(b) and a
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=1e-6, atol=1e-9,
                                   msg=k)


def test_3d_step_with_remat_equals_the_step_without():
    """train3d --remat (backbone and encoder recomputed) with dropout 0.1:
    one step through make_step on the same weights and seed."""
    from segtran_tpu_torch.cli import train3d
    from segtran_tpu_torch.nn.init import init_with_reference_schemes
    from segtran_tpu_torch.train.trainer import build_optimizer
    rng = np.random.RandomState(0)
    batch = {"image": torch.from_numpy(
                 rng.rand(1, *SHAPE, 4).astype(np.float32)),
             "label": torch.from_numpy(
                 rng.randint(0, 4, (1,) + SHAPE).astype(np.uint8))}
    out = {}
    for rematted in (False, True):
        argv = ARGV + ["--dropout", "0.1", "--bs", "1"] + (
            ["--remat"] if rematted else [])
        args = train3d.build_argparser().parse_args(argv)
        task = train3d.train_task_settings(args)
        model, cfg = train3d.build_model_and_config(args, task)
        assert cfg.remat == rematted and cfg.hidden_dropout_prob == 0.1
        init_with_reference_schemes(model, cfg, seed=0)
        opt = build_optimizer(model, lr=args.lr, decay=args.decay,
                              t_total=args.maxiter, warmup_ratio=0.5)
        step = train3d.make_step(model, opt, args, task, torch.device("cpu"))
        metrics = step(batch)
        out[rematted] = (float(metrics["loss"]), _grads(model),
                         _stats(model))
    assert out[True][0] == out[False][0]
    _assert_same(out[True][1], out[False][1])
    _assert_same(out[True][2], out[False][2])


def test_2d_step_with_remat_equals_the_step_without():
    """Segtran2d (eff-b0, 64^2) with cfg.remat and remat_blocks, dropout
    0.1 in the encoder and the out-FPN tail, drop-connect 0.2: the loss,
    every gradient and every running statistic of one step."""
    from segtran_tpu_torch.configs.base import Segtran2dConfig
    from segtran_tpu_torch.models.segtran2d import Segtran2d
    from segtran_tpu_torch.nn.attention import set_dropout_generator
    from segtran_tpu_torch.nn.init import init_with_reference_schemes
    from segtran_tpu_torch.train.trainer import make_loss_fn
    rng = np.random.RandomState(1)
    image = torch.from_numpy(rng.randn(2, 64, 64, 3).astype(np.float32))
    mask = torch.from_numpy(np.eye(3, dtype=np.float32)[
        rng.randint(0, 3, (2, 64, 64))])
    base = Segtran2dConfig(backbone_type="eff-b0", num_classes=3,
                           num_attractors=8, out_fpn_do_dropout=True).derive(
                               translayer_compress_ratios=(1.0, 1.0, 2.0))
    loss_fn = make_loss_fn(3, (0.0, 1.0, 2.0))
    out = {}
    for rematted in (False, True):
        cfg = dataclasses.replace(base, remat=rematted,
                                  remat_blocks=rematted)
        model = init_with_reference_schemes(Segtran2d(cfg), cfg, seed=0)
        set_dropout_generator(model, torch.Generator().manual_seed(7))
        loss, _ = loss_fn(model.train()(image), mask)
        loss.backward()
        out[rematted] = (float(loss.detach()), _grads(model), _stats(model))
    assert out[True][0] == out[False][0]
    _assert_same(out[True][1], out[False][1])
    _assert_same(out[True][2], out[False][2])


def test_remat_restores_the_generators_and_freezes_the_statistics():
    """What remat() adds to torch's checkpoint, on one block: the
    recompute draws the forward's drop-connect mask again and leaves the
    generator where the forward left it; the statistics move once."""
    from segtran_tpu_torch.nn.backbones.efficientnet import (
        EfficientNetFeatures)
    from segtran_tpu_torch.nn.remat import remat
    torch.manual_seed(0)
    blk = EfficientNetFeatures("eff-b0")._blocks[4].train()
    blk.drop_rate = 0.5
    x = torch.randn(8, 40, 16, 16, requires_grad=True)
    runs = {}
    for rematted in (False, True):
        blk.generator = torch.Generator().manual_seed(3)
        before = _stats(blk)
        y = remat(blk, x) if rematted else blk(x)
        y.square().sum().backward()
        after = _stats(blk)
        moved = {k: after[k] - before[k] for k in before}
        runs[rematted] = (y.detach(), x.grad.clone(), moved,
                          blk.generator.get_state())
        x.grad = None
        for k, v in before.items():                   # undo the update
            blk.get_buffer(k).copy_(v)
    for a, b in zip(runs[True][:2], runs[False][:2]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)
    _assert_same(runs[True][2], runs[False][2])
    assert torch.equal(runs[True][3], runs[False][3])
