"""One train3d step with --attnconsist held against JAX's on the CPU
with the same converted weights (Segtran3d, 8 attractors, a 48x48x16
volume, fp32, --dropout 0, no augmentation): JAX's make_train_step with
JAX train3d's aux_loss_fn against the port's make_step; the loss, the
consistency loss and every clipped gradient, to the bounds of
tests/_torch_train3d.py."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_volume import fast_variables
from test_torch_attn_consist import _jax_cfg
from _torch_parity import one_torch_thread  # noqa: F401


def test_train3d_attnconsist_step_matches_jax():
    import optax
    from segtran_tpu.data.labelmaps3d import brats_map_label
    from segtran_tpu.models.segtran3d import Segtran3d as JModel
    from segtran_tpu.train.da import (attention_consistency_loss_3d,
                                      collect_attn_scores)
    from segtran_tpu.train.trainer import (build_optimizer,
                                           create_train_state,
                                           make_train_step)
    from segtran_tpu_torch.cli import train3d
    from segtran_tpu_torch.convert import state_dict_from_jax
    from _torch_train3d import (BACKBONE_GRAD_TOL, GRAD_TOL, LOSS_RTOL,
                                SHAPE, _fro_rel, _in_backbone, _jax_loss_fn,
                                _max_rel)
    jm = JModel(_jax_cfg())
    params, bstats = fast_variables(jm, jnp.zeros((1,) + SHAPE + (4,)),
                                    seed=5)
    rng = np.random.RandomState(6)
    image = rng.rand(1, *SHAPE, 4).astype(np.float32)
    label = rng.randint(0, 4, (1,) + SHAPE).astype(np.uint8)

    def aux_loss_fn(mstate, mask):           # JAX cli/train3d.py:341-354,
        # at --attnconsistweight 0.05
        scores = collect_attn_scores(mstate)
        feat = mstate["intermediates"]["in_fpn_feat"][0]
        ac = attention_consistency_loss_3d(scores, mask,
                                           tuple(feat.shape[1:4]))
        return 0.05 * ac, {"attn_consist_loss": ac}

    keep = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda u, st, p=None: (u, u))
    tx = optax.chain(keep, build_optimizer(
        lr=2e-4, decay=1e-4, t_total=4, warmup_ratio=0.5, grad_clip=0.1))
    state = create_train_state(
        jax.tree_util.tree_map(jnp.asarray, params),
        jax.tree_util.tree_map(jnp.asarray, bstats), tx,
        jax.random.PRNGKey(1))
    step = jax.jit(make_train_step(jm, tx, _jax_loss_fn(),
                                   aux_loss_fn=aux_loss_fn))
    state, jmetrics = step(state, {
        "image": jnp.asarray(image),
        "mask": brats_map_label(jnp.asarray(label))})
    jgrads, _ = optax.clip_by_global_norm(0.1).update(state.opt_state[0],
                                                      None)

    args = train3d.build_argparser().parse_args([
        "--attractors", "8", "--patchsize", "48,48,16", "--inputsize",
        "48,48,16", "--dropout", "0", "--attnconsist",
        "--attnconsistweight", "0.05", "--randscale", "0",
        "--maxiter", "4", "--lrwarmup", "2", "--bs", "1", "--seed", "0",
        "--device", "cpu"])
    task = train3d.task_settings(args)
    model, cfg = train3d.build_model_and_config(args, task)
    assert cfg.use_attn_consist_loss
    model.load_state_dict(state_dict_from_jax(params, bstats), strict=True)
    optimizer = train3d.build_optimizer(model, lr=2e-4, decay=1e-4,
                                        t_total=4, warmup_ratio=0.5)
    tstep = train3d.make_step(model, optimizer, args, task,
                              torch.device("cpu"))
    metrics = tstep({"image": torch.from_numpy(image),
                     "label": torch.from_numpy(label)},
                    {"rot_flip": ([0], [False], [False])})
    for key in ("loss", "attn_consist_loss"):
        np.testing.assert_allclose(float(metrics[key]),
                                   float(jmetrics[key]), rtol=LOSS_RTOL,
                                   err_msg=key)
    named = dict(model.named_parameters())
    for name, g in state_dict_from_jax(
            jax.tree_util.tree_map(np.asarray, jgrads)).items():
        got, want = named[name].grad.numpy(), g.numpy()
        if name.endswith("feat_softaggr.feat2score.bias"):
            assert np.abs(got).max() < 1e-8, name
        elif _in_backbone(name):
            assert _fro_rel(got, want) < BACKBONE_GRAD_TOL, name
        else:
            assert _max_rel(got, want) < GRAD_TOL, name
