"""One train2d step of a zoo net per optimizer, the port's against JAX's.

Each case builds both steps the CLIs' way from the same flags: JAX's
``train2d.main`` up to its train state (its optimizer as main builds it,
the variables from ``jax.eval_shape``; tests/_torch_zoo.py) and one
jitted ``make_full_step``; the port's ``build_model_and_config`` ->
``build_train_optimizer`` -> ``make_step`` on the converted variables,
with JAX's augmentation draws. Held: the loss, every gradient, the
parameters and the running statistics after the step:

* BertAdam (the unet-like preset: lr 1e-3, decay 1e-4, no clip) on the
  nested U-Net;
* ``--opt sgd`` (decay 1e-4 added to the gradient, momentum 0.9);
* ``--opt adam`` (decay 1e-4 added to the gradient) on the ResNet-18 U-Net
  (64^2 patches);
* ``--optfilter``: only the matching parameters move.

Every zoo net is a chain of train-mode BatchNorms over as few as 2 x 2 x 3
values per channel, whose fp32 gradients are ill-conditioned (the
U-Net's in tests/_torch_da.py), so each trained tensor's gradient is held
by its relative Frobenius error to BACKBONE_GRAD_TOL, as those whole
steps hold theirs; the SGD update (lr times the gradient plus decay) by
the same bound, and the first Adam-family update (of unit size where a
gradient is tiny) by UPDATE_TOL. A bias in front of a BatchNorm takes a
gradient that is zero by structure (rounding noise on both sides): held
below NOISE of the largest gradient, its update within a tenth of lr.
"""
import numpy as np
import pytest
import torch

from _torch_data2d import raw_mask
from _torch_train3d import (BACKBONE_GRAD_TOL, LOSS_RTOL, UPDATE_TOL,
                            _fro_rel)
from _torch_zoo import jax_cli_step
from _torch_parity import one_torch_thread  # noqa: F401

NOISE = 1e-6          # as tests/test_torch_train2d_cli.py
BASE = ["--task", "fundus", "--split", "all", "--origsize", "64",
        "--patchsize", "32", "--bs", "2", "--maxiter", "4", "--lrwarmup",
        "2", "--seed", "0"]


def _batch():
    rng = np.random.RandomState(5)
    image = rng.rand(2, 64, 64, 3).astype(np.float32)
    mask = np.stack([raw_mask(64, 64, s) for s in (1, 2)])[..., None]
    return {"image": image, "mask": mask}


def _port_step(argv, j):
    from segtran_tpu_torch.cli import train2d
    from segtran_tpu_torch.convert import state_dict_from_jax
    args = train2d.build_argparser().parse_args(argv + ["--device", "cpu"])
    task = train2d.task_settings(args)
    model, cfg = train2d.build_model_and_config(args, task)
    assert cfg is None
    model.load_state_dict(state_dict_from_jax(j["params"], j["bstats"],
                                              model.state_dict()),
                          strict=True)
    opt, clip = train2d.build_train_optimizer(model, model, args)
    step = train2d.make_step(model, opt, args, task, torch.device("cpu"),
                             grad_clip=clip)
    return model, opt, step


@pytest.mark.parametrize("flags,kind", [
    (["--net", "nestedunet"], "BertAdam"),
    (["--net", "nestedunet", "--opt", "sgd"], "SGD"),
    # 64^2 patches: at 32^2 the encoder's layer 4 normalises over 2 values
    (["--net", "unet", "--bb", "resnet18", "--opt", "adam", "--patchsize",
      "64"], "Adam"),
    (["--net", "nestedunet", "--optfilter", "conv4_0,final"], "BertAdam")])
def test_zoo_step_matches_jax(tmp_path, flags, kind):
    from segtran_tpu_torch.convert import state_dict_from_jax
    argv = BASE + flags
    batch = _batch()
    j = jax_cli_step(argv, str(tmp_path), batch)
    model, opt, step = _port_step(argv, j)
    assert type(opt).__name__ == kind
    metrics = step({k: torch.from_numpy(v) for k, v in batch.items()},
                   j["draws"])
    np.testing.assert_allclose(float(metrics["loss"]), j["loss"],
                               rtol=LOSS_RTOL)
    named = dict(model.named_parameters())
    filters = ("conv4_0", "final") if "--optfilter" in flags else None
    p0 = state_dict_from_jax(j["params"], j["bstats"], model.state_dict())
    sd = model.state_dict()
    grads = state_dict_from_jax(j["grads"], None, sd)
    after = state_dict_from_jax(j["after"], j["bstats_after"], sd)
    gmax = max(np.abs(g.numpy()).max() for g in grads.values())
    lr = 1e-3                                   # the unet-like preset
    moved = 0
    for name, want in after.items():
        got, want, before = (sd[name].numpy(), want.numpy(),
                             p0[name].numpy())
        if name in named:
            trained = filters is None or any(f in name for f in filters)
            if not trained:
                # frozen: no gradient, no update, here as in JAX
                assert named[name].grad is None, name
                np.testing.assert_array_equal(got, before, err_msg=name)
                np.testing.assert_array_equal(want, before, err_msg=name)
                continue
            grad, jgrad = named[name].grad.numpy(), grads[name].numpy()
            if np.abs(jgrad).max() < NOISE * gmax:
                assert np.abs(grad).max() < NOISE * gmax, name
                assert np.abs(got - want).max() < 0.1 * lr, name
                continue
            assert _fro_rel(grad, jgrad) < BACKBONE_GRAD_TOL, name
            tol = BACKBONE_GRAD_TOL if kind == "SGD" else UPDATE_TOL
            assert _fro_rel(got - before, want - before) < tol, name
            moved += 1
        else:
            # running statistics after the train-mode forward
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-5,
                                       err_msg=name)
    assert moved > 0
