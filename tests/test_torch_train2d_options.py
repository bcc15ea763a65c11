"""Two train2d CLI steps of the port under the model options, held against
JAX's on the CPU (eff-tiny, batch 2, fp32, dropout and drop-connect 0,
the same converted weights, raw batch and augmentation draws): the loss of
each step, step 1's clipped gradients and the parameters after BertAdam's
second update, to the bounds of tests/test_torch_train2d_cli.py.

* ``--nosqueeze --pos bias --inbn`` on fundus (128^2 frames to 64^2
  patches): self-attention with the sliding position biases, train-mode
  BatchNorm in the in-FPN;
* ``--task oct --multihead --pos sinu`` on 64x128 frames with 10-class
  index masks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_data2d import jax_draws, raw_mask
from _torch_parity import jax_variables, to_numpy
from _torch_train3d import GRAD_TOL, LOSS_RTOL, UPDATE_TOL, _fro_rel, _max_rel
from _torch_parity import one_torch_thread  # noqa: F401

BASE = ["--bb", "eff-tiny", "--translayers", "1", "--attractors", "8",
        "--bs", "2", "--dropout", "0", "--maxiter", "4", "--lrwarmup", "2",
        "--norematblocks", "--seed", "0"]
CASES = {
    "nosqueeze_bias_inbn": dict(
        argv=["--task", "fundus", "--origsize", "128", "--patchsize", "64",
              "--nosqueeze", "--pos", "bias", "--posr", "3", "--inbn"],
        frame=(128, 128), patch=(64, 64), ds="train"),
    "oct_multihead_sinu": dict(
        argv=["--task", "oct", "--origsize", "64,128", "--patchsize",
              "64,128", "--multihead", "--pos", "sinu"],
        frame=(64, 128), patch=(64, 128), ds="duke"),
}
# a gradient whose largest entry lies below this share of the model's
# largest is zero by structure (tests/test_torch_train2d.py)
NOISE = 1e-6


def _raw_batch(case, seed=5):
    rng = np.random.RandomState(seed)
    h, w = case["frame"]
    image = rng.rand(2, h, w, 3).astype(np.float32)
    if case["ds"] == "duke":                   # OCT: layer indices 0..9
        rows = np.arange(h)[:, None] * 10 // h
        mask = np.stack([np.broadcast_to((rows + s) % 10, (h, w))
                         for s in (0, 3)]).astype(np.uint8)
    else:
        mask = np.stack([raw_mask(h, w, s) for s in (1, 2)])
    return {"image": image, "mask": mask[..., None]}


@pytest.fixture(scope="module", params=list(CASES))
def steps(request):
    """JAX's two CLI steps and the port's, on the same weights, batch and
    draws."""
    import optax
    import segtran_tpu.nn.backbones.efficientnet as jeff
    from segtran_tpu.cli import train2d as jt2
    from segtran_tpu.configs.presets import TASK_SETTINGS
    from segtran_tpu.data.augment import Aug2dConfig
    from segtran_tpu.train.trainer import build_optimizer, create_train_state
    case = CASES[request.param]
    argv = BASE + case["argv"]
    mp = pytest.MonkeyPatch()
    mp.setattr(jeff, "_drop_connect", lambda x, rate, det, rng: x)
    try:
        jargs = jt2.build_argparser().parse_args(argv)
        task = dict(TASK_SETTINGS[jargs.task_name],
                    orig_input_size=case["frame"], patch_size=case["patch"])
        jm, _ = jt2.build_model_and_config(jargs, task)
        params, bstats = jax_variables(
            jm, jnp.zeros((1,) + case["patch"] + (3,)), seed=3)
        keep = optax.GradientTransformation(
            lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
            lambda u, st, p=None: (u, u))
        tx = optax.chain(keep, build_optimizer(
            lr=2e-4, decay=1e-4, t_total=4, warmup_ratio=0.5, grad_clip=0.1))
        state = create_train_state(
            jax.tree_util.tree_map(jnp.asarray, params),
            jax.tree_util.tree_map(jnp.asarray, bstats), tx,
            jax.random.PRNGKey(1))
        mean, std = jt2.load_stats(jargs, case["ds"])
        aug_cfg = Aug2dConfig(randscale=jargs.randscale,
                              gray_alpha=jargs.gray_alpha, mean=mean, std=std)
        step = jax.jit(jt2.make_full_step(jm, tx, task, jargs, aug_cfg,
                                          case["patch"]))
        batch = _raw_batch(case)
        j = dict(params=params, bstats=bstats, losses=[], draws=[])
        for s in range(2):
            key = jax.random.fold_in(state.rng, s + 77)
            j["draws"].append(jax_draws(key, 2, aug_cfg))
            state, metrics = step(state, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
            j["losses"].append(float(metrics["loss"]))
            if s == 0:
                grads, _ = optax.clip_by_global_norm(0.1).update(
                    state.opt_state[0], None)
                j["grads"] = to_numpy(grads)
        j["after"] = to_numpy(state.params)
        j["after_stats"] = to_numpy(state.batch_stats)
    finally:
        mp.undo()
    return request.param, argv, batch, j


def test_cli_steps_match_jax(steps):
    from segtran_tpu_torch.cli import train2d
    from segtran_tpu_torch.convert import state_dict_from_jax
    from segtran_tpu_torch.train.trainer import build_optimizer
    name, argv, raw, j = steps
    args = train2d.build_argparser().parse_args(argv + ["--device", "cpu"])
    task = train2d.task_settings(args)
    model, cfg = train2d.build_model_and_config(args, task)
    if name.startswith("nosqueeze"):
        assert (not cfg.use_squeezed_transformer and cfg.in_fpn_use_bn
                and cfg.pos_code_type == "bias" and cfg.pos_bias_radius == 3)
    else:
        assert (cfg.ablate_multihead and cfg.pos_code_type == "sinu"
                and cfg.num_classes == 10)
    model.load_state_dict(state_dict_from_jax(j["params"], j["bstats"]),
                          strict=True)
    for blk in model.backbone._blocks:
        blk.drop_rate = 0.0
    opt = build_optimizer(model, lr=2e-4, decay=1e-4, t_total=4,
                          warmup_ratio=0.5)
    step = train2d.make_step(model, opt, args, task, torch.device("cpu"))
    batch = {k: torch.from_numpy(v) for k, v in raw.items()}
    named = dict(model.named_parameters())
    jgrads = {k: v.numpy() for k, v in state_dict_from_jax(j["grads"]).items()}
    gmax = max(np.abs(g).max() for g in jgrads.values())
    noise = {k for k, g in jgrads.items() if np.abs(g).max() < NOISE * gmax}
    assert len(noise) < 20
    for s in range(2):
        metrics = step(batch, j["draws"][s])
        np.testing.assert_allclose(float(metrics["loss"]), j["losses"][s],
                                   rtol=LOSS_RTOL)
        if s == 0:
            for pname, want in jgrads.items():
                got = named[pname].grad.numpy()
                if pname in noise:
                    assert np.abs(got).max() < NOISE * gmax, pname
                else:
                    assert _max_rel(got, want) < GRAD_TOL, pname
    sd = model.state_dict()
    p0 = state_dict_from_jax(j["params"], j["bstats"])
    for pname, want in state_dict_from_jax(j["after"]).items():
        got, want, d0 = sd[pname].numpy(), want.numpy(), p0[pname].numpy()
        if pname in noise:
            assert np.abs(got - d0).max() < 1e-6, pname
        else:
            assert _fro_rel(got - d0, want - d0) < UPDATE_TOL, pname
    for sname, want in state_dict_from_jax(
            {}, j["after_stats"]).items():
        np.testing.assert_allclose(sd[sname].numpy(), want.numpy(),
                                   rtol=1e-4, atol=2e-5, err_msg=sname)
